"""Collective-thrust / body-rates control.

Counterpart of gym_pybullet_adrp_tpu.control.ctbr (gains :21-24,
``position_to_ctbr`` :27, ``betaflight_motor_outputs`` :65,
``_rate_loop_forces`` :85, ``rate_loop_rpm`` :106):

* ``position_to_ctbr``: the reference's ``CTBRControl.computeControl``
  (reference control/CTBRControl.py:103-168): PD position loop -> desired
  force -> target attitude quaternion -> body-rate command.
* ``rate_loop_rpm`` / ``betaflight_motor_outputs``: a body-rate P
  controller and X mixer standing in for the Betaflight SITL rate loop the
  reference runs as external C processes over UDP (reference
  envs/BetaAviary.py:86-170).

Every function broadcasts over leading batch axes. Cross products round
each product (``_cross``), as the JAX package's ``jnp.cross`` does on the
CPU; norms are ``sqrt(sum(x * x))``, as ``jnp.linalg.norm``.
"""

import torch

from ..models.drone import DroneParams
from ..ops import quat as quat_ops
from ..utils.device_consts import const

# position loop gains (reference CTBRControl.py:149-152)
K_P = (3.0, 3.0, 8.0)
K_D = (2.5, 2.5, 5.0)
K_RATES = (5.0, 5.0, 1.0)
G_VEC = (0.0, 0.0, -9.8)
# the SITL's motor order is the inverse of BetaAviary's [2, 1, 3, 0] remap
SITL_ORDER = (3, 1, 0, 2)


def _cross(a, b):
    """``a x b`` of (..., 3) tensors, each product rounded."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _unit(v):
    """v / max(|v|, 1e-12) (the JAX package's normalization)."""
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp_min(n, 1e-12)


def position_to_ctbr(cur_pos, cur_quat, cur_vel, target_pos,
                     target_vel=None):
    """PD position loop -> (normalized thrust (...,), body rates (..., 3)).

    ``cur_quat`` is xyzw (the framework's native order). Mirrors
    CTBRControl.computeControl:149-168."""
    dtype, dev = cur_pos.dtype, cur_pos.device
    if target_vel is None:
        target_vel = torch.zeros_like(cur_pos)
    P = target_pos - cur_pos
    D = target_vel - cur_vel
    tar_acc = (const(K_P, dtype, dev) * P + const(K_D, dtype, dev) * D
               - const(G_VEC, dtype, dev))
    z_body_world = quat_ops.rotate(cur_quat, const((0.0, 0.0, 1.0), dtype,
                                                   dev).expand_as(cur_pos))
    norm_thrust = torch.sum(tar_acc * z_body_world, dim=-1)

    # target attitude from the desired acceleration direction
    z_b = _unit(tar_acc)
    x_b = _unit(_cross(const((0.0, 1.0, 0.0), dtype, dev), z_b))
    y_b = _unit(_cross(z_b, x_b))
    tar_att = quat_ops.from_matrix(torch.stack([x_b, y_b, z_b], dim=-1))

    # body rates from the attitude error quaternion (reference :163-166)
    q_err = quat_ops.multiply(quat_ops.conjugate(cur_quat), tar_att)
    body_rates = 2.0 * const(K_RATES, dtype, dev) * q_err[..., :3]
    body_rates = torch.where(q_err[..., 3:4] < 0, -body_rates, body_rates)
    return norm_thrust, body_rates


def betaflight_motor_outputs(params: DroneParams, thrust_norm, rate_sp,
                             omega_body, time_constant=0.02):
    """The in-graph Betaflight SITL: rate loop -> normalized motor outputs
    ``u`` in [0, 1], in the SITL servo packet's motor order.

    The reference's SITL processes answer each RC/FDM exchange with 4
    float motor outputs in [0, 1] (reference BetaAviary.py:162-170), which
    ``_preprocessAction`` remaps ``[2, 1, 3, 0]`` and converts with ``rpm
    = sqrt(MAX_THRUST / 4 / KF * u)`` (:239-267). These per-motor thrust
    fractions are permuted by the inverse of that remap, so the faithful
    chain recovers the IROS motor order end to end."""
    forces = _rate_loop_forces(params, thrust_norm, rate_sp, omega_body,
                               time_constant)
    u = torch.clamp(forces / (params.max_thrust[..., None] / 4.0), 0.0, 1.0)
    order = const(SITL_ORDER, torch.int64, u.device)
    return u.index_select(-1, order)


def _rate_loop_forces(params: DroneParams, thrust_norm, rate_sp, omega_body,
                      time_constant=0.02):
    """Shared rate-law core: per-motor thrusts (IROS order), unclipped
    above."""
    dtype = thrust_norm.dtype
    total_thrust = torch.minimum(
        torch.clamp_min(thrust_norm * params.mass, 0.0), params.max_thrust)
    tc = torch.as_tensor(time_constant, dtype=dtype, device=rate_sp.device)
    tau = params.J * (rate_sp - omega_body) / tc
    L = params.arm / torch.sqrt(torch.as_tensor(2.0, dtype=dtype,
                                                device=rate_sp.device))
    f = total_thrust / 4.0
    # invert the IROS X layout: tx = (f0+f1-f2-f3)L', ty = (-f0+f1+f2-f3)L',
    # tz = (t0-t1+t2-t3) with t = (km/kf)·f
    ktz = params.km / params.kf
    d_roll = tau[..., 0] / (4.0 * L)
    d_pitch = tau[..., 1] / (4.0 * L)
    d_yaw = tau[..., 2] / (4.0 * ktz)
    f0 = f + d_roll - d_pitch + d_yaw
    f1 = f + d_roll + d_pitch - d_yaw
    f2 = f - d_roll + d_pitch + d_yaw
    f3 = f - d_roll - d_pitch - d_yaw
    return torch.clamp_min(torch.stack([f0, f1, f2, f3], dim=-1), 0.0)


def rate_loop_rpm(params: DroneParams, thrust_norm, rate_sp, omega_body,
                  time_constant=0.02):
    """Body-rate P loop + X mixer -> per-motor rpm.

    thrust_norm: (...,) desired specific thrust (m/s^2, along body z);
    rate_sp / omega_body: (..., 3) rad/s. The torque demand tau = J (sp -
    w) / tc is mixed with the IROS X geometry and each motor's thrust
    converted to rpm by F = kf rpm^2."""
    forces = _rate_loop_forces(params, thrust_norm, rate_sp, omega_body,
                               time_constant)
    rpm = torch.sqrt(forces / params.kf[..., None])
    return torch.minimum(torch.clamp_min(rpm, 0.0),
                         params.max_rpm[..., None])
