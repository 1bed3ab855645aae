"""Drone parameter registry.

Counterpart of gym_pybullet_adrp_tpu.models.drone (``DroneParams`` :24,
``_REGISTRY`` :88, ``CF2X_LEGACY`` :121, ``drone_params`` :124,
``max_xy_torque`` :133): the CF2X, CF2P and racer parameters transcribed
there from the reference URDFs, and the derived quantities of the
reference's BaseAviary (hover and max rpm, max thrust and torques, the
ground-effect height clip, VelocityAviary's speed limit).

``DroneParams`` holds tensors on one device. Leaves may carry leading
batch axes; everything downstream broadcasts. The race path reads the raw
``_REGISTRY`` floats and ``CF2X_LEGACY`` (the base of its per-drone
inertia randomization).
"""

import math
from typing import NamedTuple

import torch

from ..utils.constants import G
from ..utils.enums import DroneModel


class DroneParams(NamedTuple):
    """Physical parameters of a quadrotor (tensors; leaves broadcastable)."""

    mass: torch.Tensor            # kg
    arm: torch.Tensor             # m, motor arm length L
    thrust2weight: torch.Tensor
    J: torch.Tensor               # (..., 3) diagonal inertia [Ixx, Iyy, Izz]
    kf: torch.Tensor              # thrust coefficient: F = kf * rpm^2
    km: torch.Tensor              # yaw-torque coefficient: T = km * rpm^2
    collision_h: torch.Tensor
    collision_r: torch.Tensor
    collision_z_offset: torch.Tensor
    max_speed_kmh: torch.Tensor
    gnd_eff_coeff: torch.Tensor
    prop_radius: torch.Tensor
    drag_coeff: torch.Tensor      # (..., 3) [xy, xy, z]
    dw_coeff_1: torch.Tensor
    dw_coeff_2: torch.Tensor
    dw_coeff_3: torch.Tensor

    # ---- derived quantities (reference BaseAviary.py:116-128) -------------
    @property
    def J_inv(self):
        return 1.0 / self.J

    @property
    def gravity(self):
        """Weight force G*m (the reference calls it GRAVITY)."""
        return G * self.mass

    @property
    def hover_rpm(self):
        return torch.sqrt(self.gravity / (4.0 * self.kf))

    @property
    def max_rpm(self):
        return torch.sqrt((self.thrust2weight * self.gravity)
                          / (4.0 * self.kf))

    @property
    def max_thrust(self):
        return 4.0 * self.kf * self.max_rpm ** 2

    @property
    def max_z_torque(self):
        return 2.0 * self.km * self.max_rpm ** 2

    @property
    def gnd_eff_h_clip(self):
        return 0.25 * self.prop_radius * torch.sqrt(
            (15.0 * self.max_rpm ** 2 * self.kf * self.gnd_eff_coeff)
            / self.max_thrust
        )

    @property
    def speed_limit(self):
        """VelocityAviary's speed limit (reference VelocityAviary.py:78)."""
        return 0.03 * self.max_speed_kmh * (1000.0 / 3600.0)


# raw values of the reference URDF <properties> blocks and inertial
# elements (assets/cf2x_IROS.urdf, assets/cf2p.urdf, assets/racer.urdf)
_REGISTRY = {
    DroneModel.CF2X: dict(
        mass=0.03454, arm=0.0397, thrust2weight=2.25,
        J=(1.4e-5, 1.4e-5, 2.17e-5),
        kf=3.16e-10, km=7.94e-12,
        collision_h=0.025, collision_r=0.06, collision_z_offset=0.0,
        max_speed_kmh=30.0, gnd_eff_coeff=11.36859, prop_radius=2.31348e-2,
        drag_coeff=(9.1785e-7, 9.1785e-7, 10.311e-7),
        dw_coeff_1=2267.18, dw_coeff_2=0.16, dw_coeff_3=-0.11,
    ),
    DroneModel.CF2P: dict(
        mass=0.027, arm=0.0397, thrust2weight=2.25,
        J=(2.3951e-5, 2.3951e-5, 3.2347e-5),
        kf=3.16e-10, km=7.94e-12,
        collision_h=0.025, collision_r=0.06, collision_z_offset=0.0,
        max_speed_kmh=30.0, gnd_eff_coeff=11.36859, prop_radius=2.31348e-2,
        drag_coeff=(9.1785e-7, 9.1785e-7, 10.311e-7),
        dw_coeff_1=2267.18, dw_coeff_2=0.16, dw_coeff_3=-0.11,
    ),
    DroneModel.RACE: dict(
        mass=0.830, arm=0.109, thrust2weight=4.17,
        J=(3.113e-3, 3.113e-3, 3.113e-3),
        kf=8.47e-9, km=2.13e-11,
        collision_h=0.025, collision_r=0.06, collision_z_offset=0.0,
        max_speed_kmh=200.0, gnd_eff_coeff=11.36859, prop_radius=12.7e-2,
        drag_coeff=(9.1785e-7, 9.1785e-7, 10.311e-7),
        dw_coeff_1=2267.18, dw_coeff_2=0.16, dw_coeff_3=-0.11,
    ),
}

# mass/inertia of the plain (non-IROS) cf2x urdf: the base of the race
# env's per-drone inertia randomization
CF2X_LEGACY = dict(mass=0.027, J=(1.4e-5, 1.4e-5, 2.17e-5))


def drone_params(model: DroneModel = DroneModel.CF2X, dtype=torch.float32,
                 device="cuda") -> DroneParams:
    """The ``DroneParams`` of ``model``, leaves on ``device`` (the card
    unless the caller asks for the CPU)."""
    raw = _REGISTRY[model]
    return DroneParams(**{k: torch.tensor(v, dtype=dtype, device=device)
                          for k, v in raw.items()})


def max_xy_torque(model: DroneModel, params: DroneParams):
    """Reference BaseAviary.py:121-126 (model-dependent arm geometry)."""
    if model == DroneModel.CF2P:
        return params.arm * params.kf * params.max_rpm ** 2
    return 2.0 * params.arm * params.kf * params.max_rpm ** 2 / math.sqrt(2.0)
