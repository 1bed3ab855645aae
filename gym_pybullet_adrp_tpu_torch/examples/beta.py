"""CTBR-pathway trajectory demo (reference examples/beta.py).

Counterpart of examples/beta.py: a BetaAviary drone tracks a trajectory
through the CTBR position law and the in-graph rate loop (the reference
streamed these commands to Betaflight SITL over UDP).

    python -m gym_pybullet_adrp_tpu_torch.examples.beta --plot False
"""

import argparse
import time

import numpy as np

from ..control import CTBRControl
from ..envs.beta import TRAJ_TIME, BetaAviary
from ..utils.enums import DroneModel, Physics
from ..utils.logger import Logger
from ..utils.utils import str2bool, sync

DEFAULT_GUI = False
DEFAULT_PLOT = True
DEFAULT_SIMULATION_FREQ_HZ = 500
DEFAULT_CONTROL_FREQ_HZ = 25
DEFAULT_DURATION_SEC = 12
DEFAULT_OUTPUT_FOLDER = "results"


def run(drone=DroneModel.CF2X, gui=DEFAULT_GUI, plot=DEFAULT_PLOT,
        num_drones=1, simulation_freq_hz=DEFAULT_SIMULATION_FREQ_HZ,
        control_freq_hz=DEFAULT_CONTROL_FREQ_HZ,
        duration_sec=DEFAULT_DURATION_SEC,
        output_folder=DEFAULT_OUTPUT_FOLDER, colab=False, traj_csv=None,
        device="cuda"):
    INIT_XYZS = np.array([[0.0, 0.0, 0.1]] * num_drones)
    env = BetaAviary(drone_model=drone, num_drones=num_drones,
                     initial_xyzs=INIT_XYZS, physics=Physics.PYB,
                     pyb_freq=simulation_freq_hz, ctrl_freq=control_freq_hz,
                     gui=gui, device=device)
    ctrl = CTBRControl(drone_model=drone, device=device)
    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=num_drones,
                    output_folder=output_folder, colab=colab)

    # trajectory: CSV (t, x, y, z) or a default circle. As in the reference
    # (examples/beta.py:123-137) it starts at TRAJ_TIME (the motors are
    # RC-gated off before it) with a velocity feedforward.
    NUM_STEPS = control_freq_hz * duration_sec
    t_q = np.maximum(np.arange(NUM_STEPS) / control_freq_hz - TRAJ_TIME,
                     0.0)
    if traj_csv:
        raw = np.loadtxt(traj_csv, delimiter=",", skiprows=1)
        TARGET = np.stack([np.interp(t_q, raw[:, 0], raw[:, 1 + k])
                           for k in range(3)], axis=-1)
    else:
        t_traj = t_q / max(t_q[-1], 1e-9) * 2 * np.pi
        TARGET = np.stack([0.5 * np.cos(t_traj) - 0.5,
                           0.5 * np.sin(t_traj), 1.0 + 0 * t_traj], axis=-1)
    TARGET_VEL = np.gradient(TARGET, 1.0 / control_freq_hz, axis=0)

    obs, info = env.reset()
    action = np.zeros((num_drones, 4))
    START = time.time()
    for i in range(NUM_STEPS):
        obs, reward, terminated, truncated, info = env.step(action, i)
        for j in range(num_drones):
            thrust, p, q, r = ctrl.computeControlFromState(
                control_timestep=1 / control_freq_hz, state=obs[j],
                target_pos=TARGET[i], target_vel=TARGET_VEL[i])
            action[j, :] = [thrust, p, q, r]
        logger.log(drone=0, timestamp=i / control_freq_hz, state=obs[0])
        if i % env.CTRL_FREQ == 0:
            env.render()
        if gui:
            sync(i, START, 1 / control_freq_hz)

    env.close()
    logger.save_as_csv("beta")
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="CTBR control example")
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool)
    parser.add_argument("--plot", default=DEFAULT_PLOT, type=str2bool)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER,
                        type=str)
    parser.add_argument("--traj", default=None, type=str,
                        help="trajectory CSV (t,x,y,z), e.g. "
                             "configs/beta_traj.csv")
    parser.add_argument("--device", default="cuda")
    ARGS = parser.parse_args()
    run(gui=ARGS.gui, plot=ARGS.plot, output_folder=ARGS.output_folder,
        traj_csv=ARGS.traj, device=ARGS.device)
