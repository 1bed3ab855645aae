"""Velocity-tracking demo (reference examples/pid_velocity.py).

Counterpart of examples/pid_velocity.py on the port (``device``: the
card unless the caller asks for the CPU).

A VelocityAviary drone follows a sequence of velocity commands.

    python -m gym_pybullet_adrp_tpu_torch.examples.pid_velocity --plot False
"""

import argparse
import time

import numpy as np

from ..envs.aviary import VelocityAviary
from ..utils.enums import DroneModel, Physics
from ..utils.logger import Logger
from ..utils.utils import str2bool, sync

DEFAULT_GUI = False
DEFAULT_PLOT = True
DEFAULT_SIMULATION_FREQ_HZ = 240
DEFAULT_CONTROL_FREQ_HZ = 48
DEFAULT_DURATION_SEC = 8
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
    INIT_XYZS = np.array([[0, 0, 0.1], [0.3, 0, 0.1], [0.6, 0, 0.1],
                          [0.9, 0, 0.1]])
    INIT_RPYS = np.array([[0, 0, 0], [0, 0, np.pi / 3], [0, 0, np.pi / 4],
                          [0, 0, np.pi / 2]])
    num_drones = 4

    env = VelocityAviary(
        drone_model=drone,
        num_drones=num_drones,
        initial_xyzs=INIT_XYZS,
        initial_rpys=INIT_RPYS,
        physics=Physics.PYB,
        pyb_freq=simulation_freq_hz,
        ctrl_freq=control_freq_hz,
        gui=gui,
        record=record_video,
        device=device,
    )
    logger = Logger(
        logging_freq_hz=control_freq_hz,
        num_drones=num_drones,
        output_folder=output_folder,
        colab=colab,
    )

    # piecewise velocity program (reference pid_velocity.py:96-117)
    NUM_WP = control_freq_hz * duration_sec
    wp_counters = np.zeros(num_drones, dtype=int)
    TARGET_VEL = np.zeros((num_drones, NUM_WP, 4))
    for i in range(NUM_WP):
        phase = i / NUM_WP
        for j in range(num_drones):
            if phase < 0.25:
                TARGET_VEL[j, i, :] = [0, 0, 1, 0.99]
            elif phase < 0.5:
                TARGET_VEL[j, i, :] = [np.cos(j * np.pi / 4),
                                       np.sin(j * np.pi / 4), 0, 0.99]
            elif phase < 0.75:
                TARGET_VEL[j, i, :] = [-np.cos(j * np.pi / 4),
                                       -np.sin(j * np.pi / 4), 0, 0.99]
            else:
                TARGET_VEL[j, i, :] = [0, 0, -0.5, 0.99]

    action = np.zeros((num_drones, 4))
    START = time.time()
    obs, info = env.reset()
    for i in range(0, NUM_WP):
        obs, reward, terminated, truncated, info = env.step(action)
        for j in range(num_drones):
            action[j, :] = TARGET_VEL[j, wp_counters[j], :]
        wp_counters = wp_counters + 1
        for j in range(num_drones):
            logger.log(
                drone=j,
                timestamp=i / env.CTRL_FREQ,
                state=obs[j],
                control=np.hstack([
                    TARGET_VEL[j, min(wp_counters[j], NUM_WP - 1), 0:3],
                    np.zeros(9)]),
            )
        if i % env.CTRL_FREQ == 0:
            env.render()
        if gui:
            sync(i, START, env.CTRL_TIMESTEP)

    env.close()
    logger.save_as_csv("vel")
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Velocity control example")
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool)
    parser.add_argument("--plot", default=DEFAULT_PLOT, type=str2bool)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER,
                        type=str)
    parser.add_argument("--device", default="cuda")
    ARGS = parser.parse_args()
    run(gui=ARGS.gui, plot=ARGS.plot, output_folder=ARGS.output_folder,
        device=ARGS.device)
