"""Aviary core: batched env mechanics.

Counterpart of gym_pybullet_adrp_tpu/envs/core.py (``AviaryConfig`` :26,
``CoreState`` :61, ``default_init_xyzs`` :69, ``core_reset`` :84,
``core_step`` :94, ``state_vector`` :118, ``kin_obs_12`` :137,
``adjacency_matrix`` :146, ``normalized_action_to_rpm`` :155,
``calculate_next_step`` :166). The JAX functions act on one env and are
vmapped; here every tensor carries an explicit leading batch axis B:
``(B, N, ...)`` for N drones per env.
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..models.drone import DroneParams
from ..ops import dynamics
from ..utils.enums import DroneModel, Physics


@dataclass(frozen=True)
class AviaryConfig:
    """Static env configuration (the reference BaseAviary options that
    shape the computation)."""

    drone_model: DroneModel = DroneModel.CF2X
    num_drones: int = 1
    physics: Physics = Physics.PYB
    pyb_freq: int = 240
    ctrl_freq: int = 240
    neighbourhood_radius: float = np.inf

    def __post_init__(self):
        if self.pyb_freq % self.ctrl_freq != 0:
            raise ValueError("pyb_freq must be divisible by ctrl_freq "
                             "(reference BaseAviary.__init__:79-80)")

    @property
    def steps_per_ctrl(self) -> int:
        return self.pyb_freq // self.ctrl_freq

    @property
    def ctrl_timestep(self) -> float:
        return 1.0 / self.ctrl_freq

    @property
    def pyb_timestep(self) -> float:
        return 1.0 / self.pyb_freq


class CoreState(NamedTuple):
    """Dynamic state of B envs."""

    phys: dynamics.PhysState
    last_clipped_action: torch.Tensor  # (B, N, 4) rpm
    step_counter: torch.Tensor         # (B,) int32, counts pyb substeps


def default_init_xyzs(cfg: AviaryConfig, params: DroneParams) -> np.ndarray:
    """(N, 3) default start grid (reference BaseAviary.__init__:194-197)."""
    n = cfg.num_drones
    arm = float(params.arm)
    col_h = float(params.collision_h)
    col_off = float(params.collision_z_offset)
    return np.vstack([
        np.arange(n) * 4 * arm,
        np.arange(n) * 4 * arm,
        np.ones(n) * (col_h / 2 - col_off + 0.1),
    ]).T


def core_reset(cfg: AviaryConfig, init_xyzs, init_rpys, batch: int = 1,
               dtype=torch.float32, device="cuda") -> CoreState:
    """``batch`` fresh envs at the initial poses, (N, 3) each (or (B, N,
    3) per env)."""
    xyz = torch.as_tensor(init_xyzs, dtype=dtype, device=device)
    rpy = torch.as_tensor(init_rpys, dtype=dtype, device=device)
    shape = (batch, cfg.num_drones, 3)
    phys = dynamics.initial_state(xyz.expand(shape).clone(),
                                  rpy.expand(shape).clone(), dtype, device)
    return CoreState(
        phys=phys,
        last_clipped_action=torch.zeros((batch, cfg.num_drones, 4),
                                        dtype=dtype, device=device),
        step_counter=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def core_step(cfg: AviaryConfig, params: DroneParams, state: CoreState,
              clipped_rpm) -> CoreState:
    """Advance one ctrl step of ``cfg.steps_per_ctrl`` substeps at fixed
    rpm (B, N, 4) (reference BaseAviary.step:347-387)."""
    phys, last_rpm = dynamics.ctrl_step(
        params, state.phys, clipped_rpm, state.last_clipped_action,
        cfg.pyb_timestep, cfg.steps_per_ctrl, cfg.drone_model, cfg.physics)
    return CoreState(phys=phys, last_clipped_action=last_rpm,
                     step_counter=state.step_counter + cfg.steps_per_ctrl)


def state_vector(state: CoreState) -> torch.Tensor:
    """(B, N, 20) per-drone state (reference ``_getDroneStateVector``):
    pos(3) quat(4, xyzw) rpy(3) vel(3) ang_vel_world(3) last_rpm(4)."""
    phys = state.phys
    return torch.cat([phys.pos, phys.quat, phys.rpy, phys.vel,
                      phys.ang_vel_world, state.last_clipped_action], dim=-1)


def kin_obs_12(state: CoreState) -> torch.Tensor:
    """(B, N, 12) kinematic obs: pos, rpy, vel, world angular velocity."""
    phys = state.phys
    return torch.cat([phys.pos, phys.rpy, phys.vel, phys.ang_vel_world],
                     dim=-1)


def adjacency_matrix(cfg: AviaryConfig, state: CoreState) -> torch.Tensor:
    """(B, N, N) neighbour adjacency (reference _getAdjacencyMatrix)."""
    pos = state.phys.pos
    d = torch.linalg.norm(pos[..., :, None, :] - pos[..., None, :, :],
                          dim=-1)
    adj = (d < cfg.neighbourhood_radius).to(pos.dtype)
    eye = torch.eye(pos.shape[-2], dtype=torch.bool, device=pos.device)
    return torch.where(eye, 1.0, adj)


def normalized_action_to_rpm(params: DroneParams, action):
    """[-1, 1] -> [0, MAX_RPM]: -1 -> 0, 0 -> HOVER_RPM, 1 -> MAX_RPM
    (reference _normalizedActionToRPM)."""
    hover = params.hover_rpm
    return torch.where(action <= 0, (action + 1.0) * hover,
                       hover + (params.max_rpm - hover) * action)


def calculate_next_step(current_position, destination, step_size=1.0):
    """Intermediate waypoint toward ``destination`` (reference
    _calculateNextStep), branchless."""
    direction = destination - current_position
    distance = torch.linalg.norm(direction, dim=-1, keepdim=True)
    safe = torch.clamp_min(distance, 1e-12)
    stepped = current_position + direction / safe * step_size
    return torch.where(distance <= step_size, destination, stepped)
