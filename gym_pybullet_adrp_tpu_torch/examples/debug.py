"""Raw physics-core debugging demo (reference examples/debug.py drives raw
PyBullet; here it drives the functional core directly).

Counterpart of examples/debug.py on the port: one drone at 1.001x hover
rpm, stepped by envs/core.py on ``device``.

    python -m gym_pybullet_adrp_tpu_torch.examples.debug
"""

import argparse

import numpy as np

from ..envs import core
from ..envs.core import AviaryConfig
from ..models.drone import drone_params
from ..utils.enums import DroneModel, Physics


def run(duration_sec: int = 2, physics: Physics = Physics.PYB,
        device="cuda"):
    cfg = AviaryConfig(drone_model=DroneModel.CF2X, num_drones=1,
                       physics=physics, pyb_freq=240, ctrl_freq=240)
    params = drone_params(cfg.drone_model, device=device)
    state = core.core_reset(cfg, np.array([[0.0, 0.0, 1.0]]),
                            np.zeros((1, 3)), 1, device=device)
    rpm = (params.hover_rpm * 1.001).expand(1, 1, 4)
    for i in range(duration_sec * cfg.ctrl_freq):
        state = core.core_step(cfg, params, state, rpm)
        if i % cfg.ctrl_freq == 0:
            sv = core.state_vector(state)[0, 0].cpu().numpy()
            print(f"t={i / cfg.ctrl_freq:5.2f}s pos=({sv[0]:+.3f} "
                  f"{sv[1]:+.3f} {sv[2]:+.3f}) rpy=({sv[7]:+.3f} "
                  f"{sv[8]:+.3f} {sv[9]:+.3f}) vel_z={sv[12]:+.3f}")
    return state


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Physics core debug demo")
    parser.add_argument("--duration_sec", default=2, type=int)
    parser.add_argument("--device", default="cuda")
    ARGS = parser.parse_args()
    run(duration_sec=ARGS.duration_sec, device=ARGS.device)
