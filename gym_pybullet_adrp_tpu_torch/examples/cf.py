"""Firmware-in-the-loop square trajectory (reference examples/cf.py).

Counterpart of examples/cf.py: a CFAviary drone takes off, flies a square
by FULLSTATE commands at the control rate, and the trajectory is logged.

    python -m gym_pybullet_adrp_tpu_torch.examples.cf --plot False
"""

import argparse
import time

import numpy as np

from ..envs.cf import CFAviary
from ..utils.enums import DroneModel, Physics
from ..utils.logger import Logger
from ..utils.utils import str2bool, sync

DEFAULT_GUI = False
DEFAULT_PLOT = True
DEFAULT_OUTPUT_FOLDER = "results"
DEFAULT_CONTROL_FREQ_HZ = 25
NUM_DRONES = 1
INIT_XYZ = np.array([[0.0, 0.0, 0.1]])


def square(delta=75):
    """The reference's square (cf.py:74-99): 3 s legs at 25 Hz."""
    return ([[0, 0, 0] for _ in range(delta)]
            + [[0, 0, i / delta] for i in range(delta)]
            + [[i / delta, 0, 1] for i in range(delta)]
            + [[1, i / delta, 1] for i in range(delta)]
            + [[1 - i / delta, 1, 1] for i in range(delta)]
            + [[0, 1 - i / delta, 1] for i in range(delta)]
            + [[0, 0, 1 - i / delta] for i in range(delta)])


def run(drone=DroneModel.CF2X, gui=DEFAULT_GUI, plot=DEFAULT_PLOT,
        record_video=False, output_folder=DEFAULT_OUTPUT_FOLDER,
        control_freq_hz=DEFAULT_CONTROL_FREQ_HZ, colab=False, steps=None,
        device="cuda"):
    """Fly the square; ``steps`` cuts it short. Returns the Logger."""
    env = CFAviary(drone_model=drone, num_drones=NUM_DRONES,
                   initial_xyzs=INIT_XYZ, physics=Physics.PYB, pyb_freq=500,
                   ctrl_freq=control_freq_hz, gui=gui, record=record_video,
                   device=device)
    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=NUM_DRONES,
                    output_folder=output_folder, colab=colab)
    obs, info = env.reset()
    trajectory = square()[:steps]

    START = time.time()
    env.sendTakeoffCmd(0.1, 1.0)
    for i in range(len(trajectory)):
        t = i / env.ctrl_freq
        obs, reward, terminated, truncated, info = env.step(i)
        pos = np.array(trajectory[i]) + np.array([INIT_XYZ[0][0],
                                                  INIT_XYZ[0][1], 0])
        env.sendFullStateCmd(pos, np.zeros(3), np.zeros(3), 0.0,
                             np.zeros(3), t)
        logger.log(drone=0, timestamp=i / env.ctrl_freq, state=obs[0])
        if i % env.ctrl_freq == 0:
            env.render()
        if gui:
            sync(i, START, 1 / env.ctrl_freq)

    env.close()
    logger.save_as_csv("cf")
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="CF firmware example")
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool)
    parser.add_argument("--plot", default=DEFAULT_PLOT, type=str2bool)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER,
                        type=str)
    parser.add_argument("--device", default="cuda")
    ARGS = parser.parse_args()
    run(gui=ARGS.gui, plot=ARGS.plot, output_folder=ARGS.output_folder,
        device=ARGS.device)
