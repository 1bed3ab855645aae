"""The DSL cascaded PID controller.

Counterpart of gym_pybullet_adrp_tpu.control.dslpid (the constants :23-64,
``PIDState`` :67, ``init_state`` :75, ``compute_control`` :80,
``one23d_interface`` :187): position PID -> target attitude -> attitude
PID -> mixer -> PWM -> RPM, the reference's DSLPIDControl with its
mutable members (``integral_pos_e``, ``integral_rpy_e``, ``last_rpy``)
in an explicit state, every function broadcasting over leading axes. The
JAX package computes it in XLA, outside any Pallas kernel, so here it is
plain PyTorch.

It keeps the JAX package's decisions: ``MIXER_X`` re-derived for the
cf2x_IROS propeller layout (the reference's matrix, ``MIXER_X_LEGACY``,
fits the original cf2x layout and inverts roll, pitch and yaw on IROS),
and the attitude error taken from ``target_rotation`` itself, which is
what the reference's two scipy xyzw/wxyz swaps amount to.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..models.drone import DroneParams
from ..ops import quat as quat_ops
from ..utils.device_consts import const
from ..utils.enums import DroneModel

# gains and PWM constants, reference DSLPIDControl.py:37-46
P_FOR = (0.4, 0.4, 1.25)
I_FOR = (0.05, 0.05, 0.05)
D_FOR = (0.2, 0.2, 0.5)
P_TOR = (70000.0, 70000.0, 60000.0)
I_TOR = (0.0, 0.0, 500.0)
D_TOR = (20000.0, 20000.0, 12000.0)
PWM2RPM_SCALE = 0.2685
PWM2RPM_CONST = 4070.3
MIN_PWM = 20000.0
MAX_PWM = 65535.0

# prop i of cf2x_IROS at [(+,+), (-,+), (-,-), (+,-)] L/sqrt(2), z torque
# +t0 - t1 + t2 - t3 (BaseAviary._physics:700-703)
MIXER_X = np.array([
    [0.5, -0.5, 1.0],
    [0.5, 0.5, -1.0],
    [-0.5, 0.5, 1.0],
    [-0.5, -0.5, -1.0],
])
# the reference's matrix (DSLPIDControl.py:48-53), for the original layout
MIXER_X_LEGACY = np.array([
    [-0.5, -0.5, -1.0],
    [-0.5, 0.5, 1.0],
    [0.5, 0.5, -1.0],
    [0.5, -0.5, 1.0],
])
MIXER_P = np.array([
    [0.0, -1.0, -1.0],
    [1.0, 0.0, 1.0],
    [0.0, 1.0, -1.0],
    [-1.0, 0.0, 1.0],
])


class PIDState(NamedTuple):
    """Per-drone controller state (reference DSLPIDControl.reset:65-78)."""

    last_rpy: torch.Tensor        # (..., 3)
    integral_pos_e: torch.Tensor  # (..., 3)
    integral_rpy_e: torch.Tensor  # (..., 3)


def init_state(shape=(), dtype=torch.float32, device="cuda") -> PIDState:
    """Zeroed state of ``shape`` drones on ``device`` (the card unless
    the caller asks for the CPU)."""
    z = torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device)
    return PIDState(last_rpy=z, integral_pos_e=z.clone(),
                    integral_rpy_e=z.clone())


def _c(values, like):
    return const(tuple(float(v) for v in np.ravel(values)), like.dtype,
                 like.device).reshape(np.shape(values))


def compute_control(params: DroneParams, ctl: PIDState, control_timestep,
                    cur_pos, cur_quat, cur_vel, target_pos, target_rpy=None,
                    target_vel=None, target_rpy_rates=None,
                    model: DroneModel = DroneModel.CF2X):
    """One PID control step (DSLPIDControl.computeControl:82-145).
    Returns (rpm (..., 4), new state, pos_err (..., 3), yaw_err (...))."""
    if target_rpy is None:
        target_rpy = torch.zeros_like(cur_pos)
    if target_vel is None:
        target_vel = torch.zeros_like(cur_pos)
    if target_rpy_rates is None:
        target_rpy_rates = torch.zeros_like(cur_pos)

    # ---- position control (reference :149-208) ----------------------------
    cur_rotation = quat_ops.to_matrix(cur_quat)
    pos_e = target_pos - cur_pos
    vel_e = target_vel - cur_vel
    integral_pos_e = torch.clamp(
        ctl.integral_pos_e + pos_e * control_timestep, -2.0, 2.0)
    integral_pos_e = torch.cat(
        [integral_pos_e[..., :2],
         torch.clamp(integral_pos_e[..., 2:], -0.15, 0.15)], dim=-1)
    zero = torch.zeros_like(pos_e[..., 0])
    g_vec = torch.stack(
        [zero, zero, torch.broadcast_to(params.gravity, zero.shape)], dim=-1)
    target_thrust = (_c(P_FOR, pos_e) * pos_e
                     + _c(I_FOR, pos_e) * integral_pos_e
                     + _c(D_FOR, pos_e) * vel_e + g_vec)
    scalar_thrust = torch.clamp_min(
        torch.sum(target_thrust * cur_rotation[..., :, 2], dim=-1), 0.0)
    thrust = ((torch.sqrt(scalar_thrust / (4.0 * params.kf)) - PWM2RPM_CONST)
              / PWM2RPM_SCALE)
    target_z_ax = target_thrust / torch.linalg.norm(target_thrust, dim=-1,
                                                    keepdim=True)
    yaw = target_rpy[..., 2]
    target_x_c = torch.stack([torch.cos(yaw), torch.sin(yaw),
                              torch.zeros_like(yaw)], dim=-1)
    y_cross = torch.linalg.cross(*torch.broadcast_tensors(target_z_ax,
                                                          target_x_c))
    target_y_ax = y_cross / torch.linalg.norm(y_cross, dim=-1, keepdim=True)
    target_x_ax = torch.linalg.cross(target_y_ax, target_z_ax)
    # columns are the target axes (vstack(...).T)
    target_rotation = torch.stack([target_x_ax, target_y_ax, target_z_ax],
                                  dim=-1)
    target_euler = quat_ops.to_euler_intrinsic_xyz(
        quat_ops.from_matrix(target_rotation))

    # ---- attitude control (reference :212-259) ----------------------------
    cur_rpy = quat_ops.to_euler_xyz(cur_quat)
    w_rot = target_rotation
    rot_matrix_e = (w_rot.transpose(-1, -2) @ cur_rotation
                    - cur_rotation.transpose(-1, -2) @ w_rot)
    rot_e = torch.stack([rot_matrix_e[..., 2, 1], rot_matrix_e[..., 0, 2],
                         rot_matrix_e[..., 1, 0]], dim=-1)
    rpy_rates_e = (target_rpy_rates
                   - (cur_rpy - ctl.last_rpy) / control_timestep)
    integral_rpy_e = torch.clamp(
        ctl.integral_rpy_e - rot_e * control_timestep, -1500.0, 1500.0)
    integral_rpy_e = torch.cat(
        [torch.clamp(integral_rpy_e[..., :2], -1.0, 1.0),
         integral_rpy_e[..., 2:]], dim=-1)
    target_torques = torch.clamp(
        -_c(P_TOR, rot_e) * rot_e + _c(D_TOR, rot_e) * rpy_rates_e
        + _c(I_TOR, rot_e) * integral_rpy_e, -3200.0, 3200.0)
    mixer = MIXER_P if model == DroneModel.CF2P else MIXER_X
    pwm = thrust[..., None] + target_torques @ _c(mixer, rot_e).T
    pwm = torch.clamp(pwm, MIN_PWM, MAX_PWM)
    rpm = PWM2RPM_SCALE * pwm + PWM2RPM_CONST

    new_state = PIDState(last_rpy=cur_rpy, integral_pos_e=integral_pos_e,
                         integral_rpy_e=integral_rpy_e)
    yaw_err = target_euler[..., 2] - cur_rpy[..., 2]
    return rpm, new_state, pos_e, yaw_err


def one23d_interface(params: DroneParams, thrust):
    """1-, 2- or 4-D thrust -> per-motor PWM (reference
    _one23DInterface:263-287)."""
    thrust = torch.atleast_1d(torch.as_tensor(thrust))
    dim = thrust.shape[-1]
    pwm = torch.clamp(
        (torch.sqrt(thrust / (params.kf * (4.0 / dim))) - PWM2RPM_CONST)
        / PWM2RPM_SCALE, MIN_PWM, MAX_PWM)
    if dim == 1:
        return torch.repeat_interleave(pwm, 4, dim=-1)
    if dim == 2:
        return torch.cat([pwm, torch.flip(pwm, dims=(-1,))], dim=-1)
    return pwm
