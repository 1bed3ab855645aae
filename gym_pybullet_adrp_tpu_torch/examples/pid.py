"""Helix-trajectory PID demo (reference examples/pid.py).

Counterpart of examples/pid.py on the port (``device``: the card unless
the caller asks for the CPU).

N drones track a circular/helix trajectory with the DSL PID controller in
a CtrlAviary, with flight logging and optional plotting.

    python -m gym_pybullet_adrp_tpu_torch.examples.pid --num_drones 3 \
        --plot False
"""

import argparse
import time

import numpy as np

from ..control import DSLPIDControl
from ..envs.aviary import CtrlAviary
from ..utils.enums import DroneModel, Physics
from ..utils.logger import Logger
from ..utils.utils import str2bool, sync

DEFAULT_DRONES = DroneModel.CF2X
DEFAULT_NUM_DRONES = 3
DEFAULT_PHYSICS = Physics.PYB
DEFAULT_GUI = False
DEFAULT_PLOT = True
DEFAULT_SIMULATION_FREQ_HZ = 240
DEFAULT_CONTROL_FREQ_HZ = 48
DEFAULT_DURATION_SEC = 12
DEFAULT_OUTPUT_FOLDER = "results"


def run(
    drone=DEFAULT_DRONES,
    num_drones=DEFAULT_NUM_DRONES,
    physics=DEFAULT_PHYSICS,
    gui=DEFAULT_GUI,
    record_video=False,
    plot=DEFAULT_PLOT,
    obstacles=False,
    simulation_freq_hz=DEFAULT_SIMULATION_FREQ_HZ,
    control_freq_hz=DEFAULT_CONTROL_FREQ_HZ,
    duration_sec=DEFAULT_DURATION_SEC,
    output_folder=DEFAULT_OUTPUT_FOLDER,
    colab=False,
    device="cuda",
):
    # initial poses on a circle (reference pid.py:64-70)
    H = 0.1
    H_STEP = 0.05
    R = 0.3
    INIT_XYZS = np.array(
        [
            [
                R * np.cos((i / 6) * 2 * np.pi + np.pi / 2),
                R * np.sin((i / 6) * 2 * np.pi + np.pi / 2) - R,
                H + i * H_STEP,
            ]
            for i in range(num_drones)
        ]
    )
    INIT_RPYS = np.array(
        [[0, 0, i * (np.pi / 2) / num_drones] for i in range(num_drones)]
    )

    # circular target trajectory (reference pid.py:74-84)
    PERIOD = 10
    NUM_WP = control_freq_hz * PERIOD
    TARGET_POS = np.zeros((NUM_WP, 3))
    for i in range(NUM_WP):
        TARGET_POS[i, :] = (
            R * np.cos((i / NUM_WP) * (2 * np.pi) + np.pi / 2)
            + INIT_XYZS[0, 0],
            R * np.sin((i / NUM_WP) * (2 * np.pi) + np.pi / 2) - R
            + INIT_XYZS[0, 1],
            0,
        )
    wp_counters = np.array(
        [int((i * NUM_WP / 6) % NUM_WP) for i in range(num_drones)]
    )

    env = CtrlAviary(
        drone_model=drone,
        num_drones=num_drones,
        initial_xyzs=INIT_XYZS,
        initial_rpys=INIT_RPYS,
        physics=physics,
        pyb_freq=simulation_freq_hz,
        ctrl_freq=control_freq_hz,
        gui=gui,
        record=record_video,
        obstacles=obstacles,
        device=device,
    )
    logger = Logger(
        logging_freq_hz=control_freq_hz,
        num_drones=num_drones,
        output_folder=output_folder,
        colab=colab,
    )
    ctrl = [DSLPIDControl(drone_model=drone, device=device)
            for _ in range(num_drones)]

    action = np.zeros((num_drones, 4))
    START = time.time()
    obs, info = env.reset()
    for i in range(0, int(duration_sec * env.CTRL_FREQ)):
        obs, reward, terminated, truncated, info = env.step(action)
        for j in range(num_drones):
            rpm, _, _ = ctrl[j].computeControlFromState(
                control_timestep=env.CTRL_TIMESTEP,
                state=obs[j],
                target_pos=np.hstack(
                    [TARGET_POS[wp_counters[j], 0:2], INIT_XYZS[j, 2]]
                ),
                target_rpy=INIT_RPYS[j],
            )
            action[j, :] = rpm
        wp_counters = (wp_counters + 1) % NUM_WP
        for j in range(num_drones):
            logger.log(
                drone=j,
                timestamp=i / env.CTRL_FREQ,
                state=obs[j],
                control=np.hstack(
                    [TARGET_POS[wp_counters[j], 0:2], INIT_XYZS[j, 2],
                     INIT_RPYS[j], np.zeros(6)]
                ),
            )
        if i % env.CTRL_FREQ == 0:
            env.render()
        if gui:
            sync(i, START, env.CTRL_TIMESTEP)

    env.close()
    logger.save()
    logger.save_as_csv("pid")
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Helix flight of multiple drones under DSL PID control"
    )
    parser.add_argument("--num_drones", default=DEFAULT_NUM_DRONES, type=int)
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool)
    parser.add_argument("--plot", default=DEFAULT_PLOT, type=str2bool)
    parser.add_argument("--duration_sec", default=DEFAULT_DURATION_SEC,
                        type=int)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER,
                        type=str)
    parser.add_argument("--device", default="cuda")
    ARGS = parser.parse_args()
    run(
        num_drones=ARGS.num_drones,
        gui=ARGS.gui,
        plot=ARGS.plot,
        duration_sec=ARGS.duration_sec,
        output_folder=ARGS.output_folder,
        device=ARGS.device,
    )
