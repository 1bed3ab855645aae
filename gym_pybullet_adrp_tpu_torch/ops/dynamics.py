"""Quadrotor rigid-body dynamics, all six physics modes.

Counterpart of gym_pybullet_adrp_tpu/ops/dynamics.py (``PhysState`` :32,
``thrust_torques`` :71, ``ground_effect`` :113, ``drag_force_world``
:166, ``downwash_force_body_z`` :178, ``dyn_substep`` :207,
``pyb_substep`` :234, ``substep`` :300, ``ctrl_step`` :308):

* ``Physics.DYN``: explicit dynamics (the reference's
  ``BaseAviary._dynamics``).
* ``Physics.PYB*``: semi-implicit Euler with the reference's force
  pipeline (thrust and torques, ground effect, drag, downwash) and an
  analytic ground contact in place of PyBullet's contact solver.

Plain PyTorch: the JAX package computes this in XLA outside any Pallas
kernel. The hover kernels (ops/hover_step.py) specialise the PYB mode
for one CF2X per env.

Shapes: every state tensor carries a drone axis N before its vector axis
and any batch axes before that, ``(B, N, 3)`` in the envs.
"""

import math
from typing import NamedTuple

import torch

from . import quat as quat_ops
from ..models.drone import DroneParams
from ..utils.enums import DroneModel, Physics


class PhysState(NamedTuple):
    """Kinematic state of N drones. ``omega`` is the body-frame angular
    rate; the world-frame rate is ``R(quat) @ omega``."""

    pos: torch.Tensor    # (..., N, 3) world
    quat: torch.Tensor   # (..., N, 4) xyzw
    vel: torch.Tensor    # (..., N, 3) world
    omega: torch.Tensor  # (..., N, 3) body

    @property
    def rpy(self):
        return quat_ops.to_euler_xyz(self.quat)

    @property
    def ang_vel_world(self):
        return quat_ops.rotate(self.quat, self.omega)


def initial_state(init_xyzs, init_rpys, dtype=torch.float32,
                  device="cuda") -> PhysState:
    """State at rest at the given poses (reference _housekeeping)."""
    init_xyzs = torch.as_tensor(init_xyzs, dtype=dtype, device=device)
    init_rpys = torch.as_tensor(init_rpys, dtype=dtype, device=device)
    return PhysState(
        pos=init_xyzs,
        quat=quat_ops.from_euler_xyz(init_rpys),
        vel=torch.zeros_like(init_xyzs),
        omega=torch.zeros_like(init_xyzs),
    )


def _vec(zeros, z):
    """(..., 3) vectors (0, 0, z)."""
    return torch.stack([zeros, zeros, z], dim=-1)


# ---------------------------------------------------------------------------
# force / torque models


def thrust_torques(params: DroneParams, rpm, model: DroneModel,
                   pyb_sign: bool):
    """Net body-frame thrust (scalar along +z) and torques (..., 3) from
    rpm (..., 4). The z-torque sign of the PYB pipeline (IROS prop order;
    CF2P takes the sign of its own urdf, a documented deviation of the
    JAX package) or of the DYN pipeline (RACE negates the per-motor
    torques first)."""
    forces = rpm ** 2 * params.kf[..., None]
    torques = rpm ** 2 * params.km[..., None]
    f0, f1, f2, f3 = (forces[..., i] for i in range(4))
    t0, t1, t2, t3 = (torques[..., i] for i in range(4))

    if pyb_sign:
        if model == DroneModel.CF2P:
            z_torque = -t0 + t1 - t2 + t3
        else:
            z_torque = t0 - t1 + t2 - t3
    else:
        if model == DroneModel.RACE:
            t0, t1, t2, t3 = -t0, -t1, -t2, -t3
        z_torque = -t0 + t1 - t2 + t3

    L = params.arm
    if model == DroneModel.CF2P:
        x_torque = (f1 - f3) * L
        y_torque = (-f0 + f2) * L
    else:  # CF2X / RACE: X formation
        s = L / torch.sqrt(torch.tensor(2.0, dtype=rpm.dtype,
                                        device=rpm.device))
        x_torque = (f0 + f1 - f2 - f3) * s
        y_torque = (-f0 + f1 + f2 - f3) * s

    thrust_z = f0 + f1 + f2 + f3
    return thrust_z, torch.stack([x_torque, y_torque, z_torque], dim=-1)


def ground_effect(params: DroneParams, state: PhysState, rpm,
                  model: DroneModel):
    """Per-prop ground-effect lift (reference _groundEffect), from the
    props' world heights computed from the arm geometry, gated on
    |roll|, |pitch| < pi/2. Returns (body z force, body torque (..., 3))."""
    dtype, dev = rpm.dtype, rpm.device
    L = params.arm
    z = torch.zeros_like(L)
    if model == DroneModel.CF2P:
        offs = torch.stack([
            torch.stack([L, z, z], -1), torch.stack([z, L, z], -1),
            torch.stack([-L, z, z], -1), torch.stack([z, -L, z], -1),
        ], dim=-2)
    else:
        s = L / torch.sqrt(torch.tensor(2.0, dtype=dtype, device=dev))
        zs = torch.zeros_like(s)
        offs = torch.stack([
            torch.stack([s, s, zs], -1), torch.stack([-s, s, zs], -1),
            torch.stack([-s, -s, zs], -1), torch.stack([s, -s, zs], -1),
        ], dim=-2)  # (..., 4, 3)

    prop_world = state.pos[..., None, :] + quat_ops.rotate(
        state.quat[..., None, :], offs)
    prop_h = torch.maximum(prop_world[..., 2], params.gnd_eff_h_clip[..., None])
    gnd = (rpm ** 2 * params.kf[..., None] * params.gnd_eff_coeff[..., None]
           * (params.prop_radius[..., None] / (4.0 * prop_h)) ** 2)
    rpy = state.rpy
    gate = ((torch.abs(rpy[..., 0]) < math.pi / 2)
            & (torch.abs(rpy[..., 1]) < math.pi / 2))
    gnd = gnd * gate[..., None].to(dtype)

    g0, g1, g2, g3 = (gnd[..., i] for i in range(4))
    if model == DroneModel.CF2P:
        x_t = (g1 - g3) * L
        y_t = (-g0 + g2) * L
    else:
        s = L / torch.sqrt(torch.tensor(2.0, dtype=dtype, device=dev))
        x_t = (g0 + g1 - g2 - g3) * s
        y_t = (-g0 + g1 + g2 - g3) * s
    fz = g0 + g1 + g2 + g3
    return fz, torch.stack([x_t, y_t, torch.zeros_like(x_t)], dim=-1)


def drag_force_world(params: DroneParams, state: PhysState, prev_rpm):
    """World-frame drag (reference _drag): the body-frame rotations cancel,
    leaving ``-coeff * v_world * sum(2 pi rpm / 60)``."""
    omega_sum = torch.sum(2.0 * math.pi * prev_rpm / 60.0, dim=-1,
                          keepdim=True)
    return -params.drag_coeff * omega_sum * state.vel


def downwash_force_body_z(params: DroneParams, state: PhysState):
    """Pairwise downwash body-z force per drone (reference _downwash) over
    the N x N pair matrix: drone r is pushed down by every drone s above
    it within 10 m laterally."""
    pos = state.pos
    # [receiver r, source s]: dz[r, s] = z_s - z_r
    dz = pos[..., None, :, 2] - pos[..., :, None, 2]
    dxy = torch.linalg.norm(pos[..., None, :, :2] - pos[..., :, None, :2],
                            dim=-1)
    mask = (dz > 0) & (dxy < 10.0)
    safe_dz = torch.where(mask, dz, 1.0)
    alpha = params.dw_coeff_1[..., None, None] * (
        params.prop_radius[..., None, None] / (4.0 * safe_dz)) ** 2
    beta = (params.dw_coeff_2[..., None, None] * safe_dz
            + params.dw_coeff_3[..., None, None])
    # the reference divides by beta unguarded
    safe_beta = torch.where(torch.abs(beta) > 1e-9, beta, 1e-9)
    force = -alpha * torch.exp(-0.5 * (dxy / safe_beta) ** 2)
    force = torch.where(mask, force, 0.0)
    return torch.sum(force, dim=-1)  # (..., N)


# ---------------------------------------------------------------------------
# substeps


def dyn_substep(params: DroneParams, state: PhysState, rpm, dt,
                model: DroneModel) -> PhysState:
    """Explicit-dynamics substep (reference ``_dynamics``): vel and omega
    first, then pos with the new vel, then the quaternion with the new
    body rates."""
    thrust_z, torques = thrust_torques(params, rpm, model, pyb_sign=False)
    zeros = torch.zeros_like(thrust_z)
    thrust_world = quat_ops.rotate(state.quat, _vec(zeros, thrust_z))
    force_world = thrust_world - _vec(
        zeros, torch.broadcast_to(params.gravity, zeros.shape))
    torques = torques - quat_ops._cross(state.omega, params.J * state.omega)
    omega_dot = params.J_inv * torques
    acc = force_world / params.mass[..., None]

    vel = state.vel + dt * acc
    omega = state.omega + dt * omega_dot
    pos = state.pos + dt * vel
    q = quat_ops.integrate_body(state.quat, omega, dt)
    return PhysState(pos=pos, quat=q, vel=vel, omega=omega)


def pyb_substep(params: DroneParams, state: PhysState, rpm, prev_rpm, dt,
                model: DroneModel, physics: Physics,
                ext_force_world=None) -> PhysState:
    """PyBullet-analogue substep: the force pipeline of ``physics``, then
    v += dt F/m; w_b += dt J^-1 tau_b; x += dt v'; q <- exp(w_w' dt/2) q;
    then the analytic ground contact. ``ext_force_world``: an optional
    (..., 3) world force at the COM (wind)."""
    thrust_z, torque = thrust_torques(params, rpm, model, pyb_sign=True)
    force_body_z = thrust_z

    if physics in (Physics.PYB_GND, Physics.PYB_GND_DRAG_DW):
        g_fz, g_t = ground_effect(params, state, rpm, model)
        force_body_z = force_body_z + g_fz
        torque = torque + g_t

    zeros = torch.zeros_like(force_body_z)
    force_world = quat_ops.rotate(state.quat, _vec(zeros, force_body_z))

    if physics in (Physics.PYB_DRAG, Physics.PYB_GND_DRAG_DW):
        force_world = force_world + drag_force_world(params, state, prev_rpm)

    if physics in (Physics.PYB_DW, Physics.PYB_GND_DRAG_DW):
        dw_z = downwash_force_body_z(params, state)
        force_world = force_world + quat_ops.rotate(state.quat,
                                                    _vec(zeros, dw_z))

    gravity = _vec(zeros, torch.broadcast_to(-params.gravity, zeros.shape))
    force_world = force_world + gravity
    if ext_force_world is not None:
        force_world = force_world + ext_force_world

    vel = state.vel + dt * force_world / params.mass[..., None]
    omega = state.omega + dt * params.J_inv * torque
    pos = state.pos + dt * vel
    omega_world = quat_ops.rotate(state.quat, omega)
    q = quat_ops.integrate_world(state.quat, omega_world, dt)

    # analytic ground contact at the collision cylinder's rest height
    ground_z = params.collision_h / 2.0 - params.collision_z_offset
    below = pos[..., 2] < ground_z
    pos = torch.cat([pos[..., :2],
                     torch.where(below, ground_z, pos[..., 2])[..., None]],
                    dim=-1)
    vel = torch.where(
        below[..., None],
        torch.cat([vel[..., :2] * 0.0, torch.clamp_min(vel[..., 2:3], 0.0)],
                  dim=-1),
        vel,
    )
    omega = torch.where(below[..., None], torch.zeros_like(omega), omega)
    return PhysState(pos=pos, quat=q, vel=vel, omega=omega)


def substep(params: DroneParams, state: PhysState, rpm, prev_rpm, dt,
            model: DroneModel, physics: Physics) -> PhysState:
    """One physics substep at pyb_freq."""
    if physics == Physics.DYN:
        return dyn_substep(params, state, rpm, dt, model)
    return pyb_substep(params, state, rpm, prev_rpm, dt, model, physics)


def ctrl_step(params: DroneParams, state: PhysState, rpm, prev_rpm, dt,
              n_substeps: int, model: DroneModel, physics: Physics):
    """Advance one control step of ``n_substeps`` substeps at fixed rpm.
    Drag on the first substep uses the previous control step's rpm, the
    later ones the current rpm (reference BaseAviary.step). Returns
    (state, last rpm applied)."""
    prev = prev_rpm
    for _ in range(n_substeps):
        state = substep(params, state, rpm, prev, dt, model, physics)
        prev = rpm
    return state, rpm
