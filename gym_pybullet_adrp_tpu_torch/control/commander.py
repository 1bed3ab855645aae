"""High-level commander: the command state machine and the poly7 planner.

Counterpart of gym_pybullet_adrp_tpu.control.commander (``ARGS_DIM``,
``_BASIS_INV`` :39-55, ``plan_poly7`` :58, ``eval_poly7`` :85,
``CommanderState``/``init_state`` :109-134, ``pack_command`` :136,
``process_command`` :179, ``update_setpoint`` :306). Takeoff, land and
goto plan one 7th-order segment per axis (x, y, z, yaw) with zero jerk
at both ends; every command is a mask over the batch, so a batch of
drones may each take another command in one call.

The planner's setpoint is evaluated by ``poly7_horner``, the one
evaluation the port has: the window kernel's plain version
(ops/race_window.py) and the kernel (csrc/race_window.cuh,
``poly_channel``) run the same Horner steps. The JAX package evaluates
the general path with a power basis instead; the two agree to rounding.

Command encoding (``Command`` id + float args vector, see
``pack_command``): FULLSTATE [pos(3), vel(3), acc(3), yaw, rpy_rates(3),
timestep]; TAKEOFF/LAND [height, duration]; +YAW [height, duration,
yaw]; +VEL [height, speed, relative]; GOTO [pos(3), yaw, duration,
relative].
"""

from typing import NamedTuple

import numpy as np
import torch

from ..ops import quat as quat_ops
from ..utils.constants import RAD_TO_DEG
from ..utils.device_consts import const
from ..utils.enums import Command
from .mellinger import MODE_ABS, MODE_DISABLE, Setpoint, zero_setpoint

ARGS_DIM = 14


# ---------------------------------------------------------------------------
# poly7 "no jerk" segment in normalized time s = t/T:
# p(0)=x0 p'(0)=v0 p''(0)=a0 p'''(0)=0 ; p(1)=xf p'(1)=vf p''(1)=af p'''(1)=0


def _basis_inverse() -> np.ndarray:
    A = np.zeros((8, 8))
    A[0, 0] = 1.0
    A[1, 1] = 1.0
    A[2, 2] = 2.0
    A[3, 3] = 6.0
    for i in range(8):
        A[4, i] = 1.0
        A[5, i] = i
        A[6, i] = i * (i - 1)
        A[7, i] = i * (i - 1) * (i - 2)
    return np.linalg.inv(A)


_BASIS_INV = _basis_inverse()
_BASIS_INV_T = tuple(map(tuple, _BASIS_INV.T))


def plan_poly7(x0, v0, a0, xf, vf, af, T):
    """Coefficients (..., C, 8) in normalized time for C channels. x0..af
    are (..., C), T is (...,); T <= 0 degenerates to the constant xf."""
    T = T[..., None]
    safe_T = torch.where(T > 0, T, 1.0)
    zero = torch.zeros_like(x0)
    b = torch.stack([x0, v0 * safe_T, a0 * (safe_T * safe_T), zero, xf,
                     vf * safe_T, af * (safe_T * safe_T), zero], dim=-1)
    basis = const(_BASIS_INV_T, x0.dtype, x0.device)
    coeffs = b @ basis
    hold = torch.zeros_like(coeffs)
    hold[..., 0] = xf
    return torch.where(T[..., None] > 0, coeffs, hold)


def poly7_horner(c, s, safe_T):
    """(p, v, a) of one poly7 channel at normalized time ``s``: ``c`` is a
    sequence of its 8 coefficient tensors (c[i] multiplies s**i)."""
    pv = c[7]
    dv = 7.0 * c[7]
    av = 42.0 * c[7]
    for i in range(6, -1, -1):
        pv = pv * s + c[i]
        if i >= 1:
            dv = dv * s + float(i) * c[i]
        if i >= 2:
            av = av * s + float(i * (i - 1)) * c[i]
    return pv, dv / safe_T, av / (safe_T * safe_T)


def eval_poly7(coeffs, t_rel, T):
    """Position, velocity and acceleration (each (..., C)) at ``t_rel``
    clamped to [0, T]; coeffs (..., C, 8), t_rel and T (...,). Beyond T
    the end state holds."""
    safe_T = torch.where(T > 0, T, 1.0)[..., None]
    s = torch.clamp(t_rel[..., None] / safe_T, 0.0, 1.0)
    return poly7_horner(coeffs.unbind(-1), s, safe_T)


# ---------------------------------------------------------------------------
# commander state


class CommanderState(NamedTuple):
    """Per-drone commander + planner state."""

    setpoint: Setpoint
    full_state_override: torch.Tensor  # (...,) bool
    planner_active: torch.Tensor       # (...,) bool
    coeffs: torch.Tensor               # (..., 4, 8) channels x, y, z, yaw
    t_begin: torch.Tensor              # (...,) s
    duration: torch.Tensor             # (...,) s


def init_state(shape=(), dtype=torch.float32,
               device="cuda") -> CommanderState:
    return CommanderState(
        setpoint=zero_setpoint(shape, dtype, device),
        full_state_override=torch.ones(shape, dtype=torch.bool,
                                       device=device),
        planner_active=torch.zeros(shape, dtype=torch.bool, device=device),
        coeffs=torch.zeros(shape + (4, 8), dtype=dtype, device=device),
        t_begin=torch.zeros(shape, dtype=dtype, device=device),
        duration=torch.zeros(shape, dtype=dtype, device=device),
    )


def pack_command(cmd: Command, args=()) -> tuple:
    """-> (cmd_id, args_vec float32[ARGS_DIM]) (host-side)."""
    vec = np.zeros(ARGS_DIM, dtype=np.float32)
    if cmd == Command.FULLSTATE:
        pos, vel, acc, yaw, rpy_rate, timestep = args
        vec[0:3] = np.asarray(pos, dtype=np.float32)
        vec[3:6] = np.asarray(vel, dtype=np.float32)
        vec[6:9] = np.asarray(acc, dtype=np.float32)
        vec[9] = float(yaw)
        vec[10:13] = np.asarray(rpy_rate, dtype=np.float32)
        vec[13] = float(timestep)
    elif cmd in (Command.TAKEOFF, Command.LAND):
        vec[0], vec[1] = float(args[0]), float(args[1])
    elif cmd in (Command.TAKEOFFYAW, Command.LANDYAW):
        vec[0], vec[1], vec[2] = (float(args[0]), float(args[1]),
                                  float(args[2]))
    elif cmd in (Command.TAKEOFFVEL, Command.LANDVEL):
        vec[0], vec[1], vec[2] = (float(args[0]), float(args[1]),
                                  float(bool(args[2])))
    elif cmd == Command.GOTO:
        pos, yaw, duration, relative = args
        vec[0:3] = np.asarray(pos, dtype=np.float32)
        vec[3] = float(yaw)
        vec[4] = float(duration)
        vec[5] = float(bool(relative))
    return int(cmd), vec


# ---------------------------------------------------------------------------
# command execution


def _mask(cond, new, old):
    c = cond.reshape(cond.shape + (1,) * (new.dim() - cond.dim()))
    return torch.where(c, new, old)


def process_command(state: CommanderState, cmd_id, args, sim_time,
                    cur_pos, cur_vel, cur_yaw) -> CommanderState:
    """Execute one command per drone, as masks. cmd_id (...,) int; args
    (..., ARGS_DIM); sim_time broadcasts to cmd_id. Takeoff/land plan from
    rest, goto from the current motion state."""
    dtype, dev = cur_pos.dtype, cur_pos.device
    sim_time = torch.broadcast_to(
        torch.as_tensor(sim_time, dtype=dtype, device=dev), cmd_id.shape)
    zero3 = torch.zeros_like(cur_pos)

    def is_(*cmds):
        out = cmd_id == int(cmds[0])
        for c in cmds[1:]:
            out = out | (cmd_id == int(c))
        return out

    is_fullstate = is_(Command.FULLSTATE)
    is_takeoff = is_(Command.TAKEOFF, Command.TAKEOFFYAW, Command.TAKEOFFVEL)
    is_land = is_(Command.LAND, Command.LANDYAW, Command.LANDVEL)
    is_goto = is_(Command.GOTO)
    is_stop = is_(Command.STOP)
    plans = is_takeoff | is_land | is_goto
    any_cmd = plans | is_fullstate | is_stop | is_(Command.NOTIFY)

    # FULLSTATE (reference _sendFullStateCmd:510-543)
    sp = state.setpoint
    fs_yaw = args[..., 9]
    zy = torch.zeros_like(fs_yaw)
    fs_quat = quat_ops.from_euler_xyz(torch.stack([zy, zy, fs_yaw], -1))

    # planned trajectories
    height = args[..., 0]
    speed = args[..., 1]
    is_yawed = is_(Command.TAKEOFFYAW, Command.LANDYAW)
    is_vel_cmd = is_(Command.TAKEOFFVEL, Command.LANDVEL)
    tl_height = torch.where(is_vel_cmd & (args[..., 2] > 0.5),
                            cur_pos[..., 2] + height, height)
    tl_duration = torch.where(
        is_vel_cmd,
        torch.abs(tl_height - cur_pos[..., 2])
        / torch.clamp_min(torch.abs(speed), 1e-6),
        args[..., 1])
    tl_target = torch.cat([cur_pos[..., :2], tl_height[..., None]], dim=-1)
    tl_yaw = torch.where(is_yawed, args[..., 2], cur_yaw)

    goto_rel = args[..., 5] > 0.5
    goto_target = torch.where(goto_rel[..., None], cur_pos + args[..., 0:3],
                              args[..., 0:3])
    goto_yaw = torch.where(goto_rel, cur_yaw + args[..., 3], args[..., 3])

    target_pos = torch.where(is_goto[..., None], goto_target, tl_target)
    target_yaw = torch.where(is_goto, goto_yaw, tl_yaw)
    duration = torch.where(is_goto, args[..., 4], tl_duration)
    v0 = torch.where(is_goto[..., None], cur_vel, zero3)
    zy = torch.zeros_like(cur_yaw)[..., None]
    x0 = torch.cat([cur_pos, cur_yaw[..., None]], dim=-1)
    xf = torch.cat([target_pos, target_yaw[..., None]], dim=-1)
    zf = torch.zeros_like(xf)
    new_coeffs = plan_poly7(x0, torch.cat([v0, zy], dim=-1),
                            torch.cat([zero3, zy], dim=-1), xf, zf, zf,
                            duration)

    def full(x, v):
        return torch.full_like(x, v)

    new_setpoint = Setpoint(
        pos=_mask(is_fullstate, args[..., 0:3], sp.pos),
        vel=_mask(is_fullstate, args[..., 3:6], sp.vel),
        acc=_mask(is_fullstate, args[..., 6:9], sp.acc),
        att_rpy=sp.att_rpy,
        att_rate=_mask(is_fullstate, args[..., 10:13] * RAD_TO_DEG,
                       sp.att_rate),
        att_quat=_mask(is_fullstate, fs_quat, sp.att_quat),
        thrust=torch.where(is_stop, 0.0, sp.thrust),
        mode_xyz=_mask(is_fullstate, full(sp.mode_xyz, MODE_ABS),
                       _mask(is_stop, full(sp.mode_xyz, MODE_DISABLE),
                             sp.mode_xyz)),
        mode_rpy=_mask(is_fullstate, full(sp.mode_rpy, MODE_DISABLE),
                       sp.mode_rpy),
        mode_quat=torch.where(
            is_fullstate, full(sp.mode_quat, MODE_ABS),
            torch.where(is_stop, full(sp.mode_quat, MODE_DISABLE),
                        sp.mode_quat)),
    )
    return CommanderState(
        setpoint=new_setpoint,
        # any other command hands control to the high-level commander
        full_state_override=torch.where(
            is_fullstate, True,
            torch.where(any_cmd, False, state.full_state_override)),
        # the queue stops the planner before executing; STOP leaves it so
        planner_active=torch.where(
            plans, True, torch.where(any_cmd, False, state.planner_active)),
        coeffs=_mask(plans, new_coeffs, state.coeffs),
        t_begin=torch.where(plans, sim_time, state.t_begin),
        duration=torch.where(plans, duration, state.duration),
    )


def update_setpoint(state: CommanderState, sim_time) -> CommanderState:
    """Per-tick setpoint refresh from the planner where the high-level
    commander is in control (reference _update_setpoint:369-374)."""
    sp = state.setpoint
    t_rel = sim_time - state.t_begin
    pos4, vel4, acc4 = eval_poly7(state.coeffs, t_rel, state.duration)
    use = ~state.full_state_override & state.planner_active

    yaw_deg = pos4[..., 3] * RAD_TO_DEG
    z = torch.zeros_like(yaw_deg)
    att_rpy = torch.stack([z, z, yaw_deg], dim=-1)
    rate_deg = torch.stack([z, z, vel4[..., 3] * RAD_TO_DEG], dim=-1)
    mode_rpy = torch.full_like(sp.mode_rpy, MODE_DISABLE)
    mode_rpy[..., 2] = MODE_ABS
    new_setpoint = Setpoint(
        pos=_mask(use, pos4[..., :3], sp.pos),
        vel=_mask(use, vel4[..., :3], sp.vel),
        acc=_mask(use, acc4[..., :3], sp.acc),
        att_rpy=_mask(use, att_rpy, sp.att_rpy),
        att_rate=_mask(use, rate_deg, sp.att_rate),
        att_quat=sp.att_quat,
        thrust=sp.thrust,
        mode_xyz=_mask(use, torch.full_like(sp.mode_xyz, MODE_ABS),
                       sp.mode_xyz),
        # GetSetpoint: yaw modeAbs, roll/pitch and quat modeDisable
        mode_rpy=_mask(use, mode_rpy, sp.mode_rpy),
        mode_quat=torch.where(use, MODE_DISABLE, sp.mode_quat),
    )
    return state._replace(setpoint=new_setpoint)
