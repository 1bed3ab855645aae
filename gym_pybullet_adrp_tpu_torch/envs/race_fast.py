"""The general race step with its firmware window in the K3 kernel.

Counterpart of gym_pybullet_adrp_tpu/envs/race_fast.py (``supports``
:30, ``pack_blocks`` :44, ``sp_override`` :116, ``unpack_blocks`` :120,
``race_window_fast`` :169, ``race_step_fast`` :186,
``batched_race_step_fast`` :195): the commands are processed as in
envs/race.py, every drone of every env is packed into the channel-major
blocks of ops/race_window.py, one ``race_window`` launch runs the 20
ticks of physics, planner setpoint and Mellinger firmware for all B x N
agents, and the state is unpacked for envs/race.py's tail (gate
progress, collisions, termination, obs). Supported: ``Physics.PYB``,
CF2X, no disturbances (other configurations take ``race.race_step``).

The JAX package's per-env ``race_step_fast`` and its vmapped
``batched_race_step_fast`` are one function here, on the batch. The
window's constants fold once per spec (``window_consts_of``); a caller
that steps many times passes them in as ``consts``.
"""

import torch

from ..control import mellinger as mel
from ..ops import quat as quat_ops
from ..ops import race_window as rw
from ..utils.constants import RAD_TO_DEG
from ..utils.enums import DroneModel, Physics
from . import race as race_mod
from .race import RaceSpec, RaceState, RaceTrack, model_scalars

LANE = rw.LANE


def supports(spec: RaceSpec) -> bool:
    return (spec.physics == Physics.PYB
            and spec.drone_model == DroneModel.CF2X
            and not spec.disturbances)


def window_consts_of(spec: RaceSpec):
    """The window kernel's folded constants for ``spec`` (model scalars,
    tick length, ticks per control step)."""
    kf, km, arm, ground_z = model_scalars(spec)
    return rw.window_consts(kf, km, arm, ground_z, 1.0 / spec.pyb_freq,
                            spec.steps_per_ctrl)


def _blocks(cols, agents):
    """(A, k) columns -> a (k, T, 128) channel-major block, the agents
    zero-padded to a multiple of 128."""
    x = torch.cat([c.reshape(agents, -1).to(torch.float32) for c in cols],
                  dim=1)
    total = -(-agents // LANE) * LANE
    if total != agents:
        x = torch.nn.functional.pad(x, (0, 0, 0, total - agents))
    return x.T.reshape(x.shape[1], total // LANE, LANE).contiguous()


def sp_override(cmdr):
    return cmdr.full_state_override


def pack_blocks(state: RaceState, agents: int):
    """A race state whose per-drone leaves hold ``agents`` rows -> the
    (S, W) blocks of ops/race_window.py."""
    m, c = state.mell, state.cmdr
    S = _blocks([
        state.phys.pos, state.phys.quat, state.phys.vel, state.phys.omega,
        state.rpms, state.prev_rpms, m.prev_rpy, m.prev_vel,
        m.acc_lpf.d1, m.acc_lpf.d2, m.gyro_lpf.d1, m.gyro_lpf.d2,
        m.i_error_pos, m.i_error_m, m.prev_omega_rp,
        m.prev_setpoint_omega_rp, m.control_rpyt, m.tick,
        m.last_pos_pid_call, m.last_att_pid_call, m.tumble_counter,
        m.error_flag,
    ], agents)
    sp = c.setpoint
    planner = (~sp_override(c)) & c.planner_active
    # window-static desired yaw: quat (FULLSTATE) > att_rpy ABS > 0
    yaw_quat_deg = quat_ops.to_euler_xyz(sp.att_quat)[..., 2] * RAD_TO_DEG
    yaw_static = torch.where(
        sp.mode_quat == mel.MODE_ABS, yaw_quat_deg,
        torch.where(sp.mode_rpy[..., 2] == mel.MODE_ABS, sp.att_rpy[..., 2],
                    0.0))
    pos_mode = planner | (sp.mode_xyz[..., 0] == mel.MODE_ABS)
    z_disable = (~planner) & (sp.mode_xyz[..., 2] == mel.MODE_DISABLE)
    W = _blocks([
        sp.pos, sp.vel, sp.acc, sp.att_rate, yaw_static, sp.thrust,
        pos_mode, z_disable, planner, c.t_begin, c.duration,
        state.eliminated, c.coeffs, state.drone.mass, state.drone.J,
        torch.zeros_like(c.t_begin),  # reserved
    ], agents)
    return S, W


def unpack_blocks(S, state: RaceState, agents: int) -> RaceState:
    """The window's S block -> ``state`` with its kinematics, rpms and
    firmware replaced (commander, gates and counters kept)."""
    flat = S.reshape(rw.S_CHANNELS, -1)[:, :agents].T     # (A, 58)
    shape = state.rpms.shape[:-1]

    def v(lo, hi):
        return flat[:, lo:hi].reshape(shape + (hi - lo,))

    def one(k):
        return flat[:, k].reshape(shape)

    m = state.mell
    mell = m._replace(
        prev_rpy=v(21, 24), prev_vel=v(24, 27),
        acc_lpf=m.acc_lpf._replace(d1=v(27, 30), d2=v(30, 33)),
        gyro_lpf=m.gyro_lpf._replace(d1=v(33, 36), d2=v(36, 39)),
        i_error_pos=v(39, 42), i_error_m=v(42, 45),
        prev_omega_rp=v(45, 47), prev_setpoint_omega_rp=v(47, 49),
        control_rpyt=v(49, 53), tick=one(53).to(torch.int32),
        last_pos_pid_call=one(54), last_att_pid_call=one(55),
        tumble_counter=one(56).to(torch.int32), error_flag=one(57) > 0.5,
    )
    phys = state.phys._replace(pos=v(0, 3), quat=v(3, 7), vel=v(7, 10),
                               omega=v(10, 13))
    return state._replace(phys=phys, rpms=v(13, 17), prev_rpms=v(17, 21),
                          mell=mell)


def race_window_fast(spec: RaceSpec, state: RaceState,
                     consts=None) -> RaceState:
    """One control step's firmware window for every drone of every env in
    one ``race_window`` launch; advances the step counters."""
    agents = state.rpms.shape[0] * state.rpms.shape[1]
    S, W = pack_blocks(state, agents)
    S = rw.race_window(*model_scalars(spec), S, W,
                       n_ticks=spec.steps_per_ctrl, dt=1.0 / spec.pyb_freq,
                       consts=consts or window_consts_of(spec))
    state = unpack_blocks(S, state, agents)
    return state._replace(step_counter=state.step_counter
                          + spec.steps_per_ctrl)


def batched_race_step_fast(spec: RaceSpec, track: RaceTrack,
                           state: RaceState, cmd_ids, cmd_args, consts=None):
    """``race.race_step`` with the window in the kernel: cmd_ids (B, N),
    cmd_args (B, N, ARGS_DIM); returns what ``race.race_step`` returns.
    The commander's setpoint is not refreshed per tick in the state (the
    kernel evaluates the planner itself), as in the JAX package. The
    kernel has no backward: a call that autograd would record raises."""
    rw.refuse_grad("race_fast.batched_race_step_fast", rw.RACE_EAGER,
                   cmd_args, state.phys.pos, state.phys.vel,
                   state.phys.quat, state.phys.omega)
    if not supports(spec):
        raise ValueError("race_fast: PYB physics, CF2X drones and no "
                         "disturbances only; use race.race_step")
    state = race_mod.process_commands(spec, state, cmd_ids, cmd_args)
    state = race_window_fast(spec, state, consts)
    return race_mod.finish_ctrl_step(spec, track, state)
