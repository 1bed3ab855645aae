"""Two-drone downwash demo (reference examples/downwash.py).

Counterpart of examples/downwash.py on the port (``device``: the card
unless the caller asks for the CPU).

The lower drone flies under the upper one with Physics.PYB_DW so the
downwash force model perturbs it.

    python -m gym_pybullet_adrp_tpu_torch.examples.downwash --plot False
"""

import argparse
import time

import numpy as np

from ..control import DSLPIDControl
from ..envs.aviary import CtrlAviary
from ..utils.enums import DroneModel, Physics
from ..utils.logger import Logger
from ..utils.utils import str2bool, sync

DEFAULT_GUI = False
DEFAULT_PLOT = True
DEFAULT_SIMULATION_FREQ_HZ = 240
DEFAULT_CONTROL_FREQ_HZ = 48
DEFAULT_DURATION_SEC = 12
DEFAULT_OUTPUT_FOLDER = "results"


def run(
    drone=DroneModel.CF2X,
    gui=DEFAULT_GUI,
    record_video=False,
    plot=DEFAULT_PLOT,
    simulation_freq_hz=DEFAULT_SIMULATION_FREQ_HZ,
    control_freq_hz=DEFAULT_CONTROL_FREQ_HZ,
    duration_sec=DEFAULT_DURATION_SEC,
    output_folder=DEFAULT_OUTPUT_FOLDER,
    colab=False,
    device="cuda",
):
    INIT_XYZS = np.array([[0.5, 0, 1], [-0.5, 0, 0.5]])
    env = CtrlAviary(
        drone_model=drone,
        num_drones=2,
        initial_xyzs=INIT_XYZS,
        physics=Physics.PYB_DW,
        pyb_freq=simulation_freq_hz,
        ctrl_freq=control_freq_hz,
        gui=gui,
        record=record_video,
        device=device,
    )
    ctrl = [DSLPIDControl(drone_model=drone, device=device)
            for _ in range(2)]
    logger = Logger(
        logging_freq_hz=control_freq_hz,
        num_drones=2,
        output_folder=output_folder,
        colab=colab,
    )

    # crossing sinusoid trajectories (reference downwash.py:62-70)
    PERIOD = 5
    NUM_WP = control_freq_hz * PERIOD
    TARGET_POS = np.zeros((NUM_WP, 2))
    for i in range(NUM_WP):
        TARGET_POS[i, :] = [0.5 * np.cos(2 * np.pi * (i / NUM_WP)), 0]
    wp_counters = np.array([0, int(NUM_WP / 2)])

    action = np.zeros((2, 4))
    START = time.time()
    obs, info = env.reset()
    for i in range(0, int(duration_sec * env.CTRL_FREQ)):
        obs, reward, terminated, truncated, info = env.step(action)
        for j in range(2):
            rpm, _, _ = ctrl[j].computeControlFromState(
                control_timestep=env.CTRL_TIMESTEP,
                state=obs[j],
                target_pos=np.hstack(
                    [TARGET_POS[wp_counters[j], :], INIT_XYZS[j, 2]]
                ),
            )
            action[j, :] = rpm
        wp_counters = (wp_counters + 1) % NUM_WP
        for j in range(2):
            logger.log(
                drone=j,
                timestamp=i / env.CTRL_FREQ,
                state=obs[j],
                control=np.hstack(
                    [TARGET_POS[wp_counters[j], :], INIT_XYZS[j, 2],
                     np.zeros(9)]
                ),
            )
        if i % env.CTRL_FREQ == 0:
            env.render()
        if gui:
            sync(i, START, env.CTRL_TIMESTEP)

    env.close()
    logger.save_as_csv("dw")
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Downwash example")
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool)
    parser.add_argument("--plot", default=DEFAULT_PLOT, type=str2bool)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER,
                        type=str)
    parser.add_argument("--device", default="cuda")
    ARGS = parser.parse_args()
    run(gui=ARGS.gui, plot=ARGS.plot, output_folder=ARGS.output_folder,
        device=ARGS.device)
