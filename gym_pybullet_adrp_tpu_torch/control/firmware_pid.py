"""Crazyflie firmware cascaded PID controller (``controllerPid``).

Counterpart of gym_pybullet_adrp_tpu.control.firmware_pid (the gains
:27-51, ``Pid`` :53, ``_pid_update`` :60, ``PidControllerState`` :67,
``init_state`` :89, ``_wrap180`` :105, ``_position_controller`` :109,
``controller_pid`` :155), the controller CFPIDAviary (envs/cf.py) runs at
1 kHz on the firmware structs of control/mellinger.py:

  position (100 Hz): pos P -> velocity setpoint -> velocity PID -> desired
  roll/pitch (yaw-rotated, clamped to 20 deg) + thrust (scale + base, min
  clamp); attitude (500 Hz): angle PID -> rate setpoints; rate PID ->
  actuator roll/pitch/yaw commands (int16 range), with the firmware's sign
  conventions (legacy inverted pitch state, negated gyro.y, negated yaw
  output).

All controller state is an explicit NamedTuple of tensors; every function
broadcasts over leading batch axes. Divisions by constants are products
with the float32 reciprocal (``mellinger.recip32``), as in
control/mellinger.py.
"""

from typing import NamedTuple

import torch

from ..utils.constants import RAD_TO_DEG
from .mellinger import (
    FirmwareState, MODE_ABS, MODE_DISABLE, MODE_VELOCITY, Setpoint, _bcast,
    recip32,
)

ATTITUDE_DT = 1.0 / 500.0
POSITION_DT = 1.0 / 100.0

# firmware default gains
# attitude angle loops (deg -> deg/s)
ROLL_KP, ROLL_KI, ROLL_KD, ROLL_ILIM = 6.0, 3.0, 0.0, 20.0
PITCH_KP, PITCH_KI, PITCH_KD, PITCH_ILIM = 6.0, 3.0, 0.0, 20.0
YAW_KP, YAW_KI, YAW_KD, YAW_ILIM = 6.0, 1.0, 0.35, 360.0
# rate loops (deg/s -> actuator)
RR_KP, RR_KI, RR_KD, RR_ILIM = 250.0, 500.0, 2.5, 33.3
PR_KP, PR_KI, PR_KD, PR_ILIM = 250.0, 500.0, 2.5, 33.3
YR_KP, YR_KI, YR_KD, YR_ILIM = 120.0, 16.7, 0.0, 166.7
# position/velocity loops
POS_KP = 2.0
POS_Z_KP, POS_Z_KI = 2.0, 0.5
VEL_MAX = 1.0
VX_KP, VX_KI = 25.0, 1.0
VZ_KP, VZ_KI = 25.0, 15.0
RP_LIMIT = 20.0
THRUST_BASE = 36000.0
THRUST_SCALE = 1000.0
THRUST_MIN = 20000.0
INT16_MAX = 32767.0


class Pid(NamedTuple):
    """One firmware PidObject's mutable state."""

    integ: torch.Tensor
    prev_error: torch.Tensor


def _pid_update(pid: Pid, error, dt, kp, ki, kd, i_limit):
    integ = torch.clamp(pid.integ + error * dt, -i_limit, i_limit)
    deriv = (error - pid.prev_error) * recip32(dt)
    out = kp * error + ki * integ + kd * deriv
    return Pid(integ=integ, prev_error=error), out


class PidControllerState(NamedTuple):
    """All controllerPid statics (leaves (...,))."""

    att_roll: Pid
    att_pitch: Pid
    att_yaw: Pid
    rate_roll: Pid
    rate_pitch: Pid
    rate_yaw: Pid
    pos_z: Pid
    vel_x: Pid
    vel_y: Pid
    vel_z: Pid
    # held outputs between gated ticks
    control_rpyt: torch.Tensor      # (..., 4)
    att_desired_rpy: torch.Tensor   # (..., 3) deg
    actuator_thrust: torch.Tensor   # (...,)
    tick: torch.Tensor              # (...,) int32
    last_pos_call: torch.Tensor
    last_att_call: torch.Tensor


def init_state(shape=(), dtype=torch.float32,
               device="cuda") -> PidControllerState:
    def z(*d):
        return torch.zeros(tuple(shape) + d, dtype=dtype, device=device)

    def p():
        return Pid(integ=z(), prev_error=z())

    return PidControllerState(
        att_roll=p(), att_pitch=p(), att_yaw=p(),
        rate_roll=p(), rate_pitch=p(), rate_yaw=p(),
        pos_z=p(), vel_x=p(), vel_y=p(), vel_z=p(),
        control_rpyt=z(4), att_desired_rpy=z(3), actuator_thrust=z(),
        tick=torch.zeros(tuple(shape), dtype=torch.int32, device=device),
        last_pos_call=z(), last_att_call=z(),
    )


def _wrap180(x):
    # Python's floor modulo, as jnp's %: torch.remainder, not fmod
    return torch.remainder(x + 180.0, 360.0) - 180.0


def _position_controller(state: PidControllerState, sp: Setpoint,
                         fw: FirmwareState):
    """positionController + velocityController (100 Hz). Returns (new
    pids, desired attitude rpy deg, thrust)."""
    dt = POSITION_DT
    # position P -> velocity setpoints (x/y kp only, clamped)
    vx_sp = torch.clamp(POS_KP * (sp.pos[..., 0] - fw.pos[..., 0]),
                        -VEL_MAX, VEL_MAX)
    vy_sp = torch.clamp(POS_KP * (sp.pos[..., 1] - fw.pos[..., 1]),
                        -VEL_MAX, VEL_MAX)
    pos_z, vz_from_z = _pid_update(
        state.pos_z, sp.pos[..., 2] - fw.pos[..., 2], dt,
        POS_Z_KP, POS_Z_KI, 0.0, 5000.0)
    vz_sp = torch.clamp(vz_from_z, -VEL_MAX, VEL_MAX)
    # velocity-mode setpoints pass straight through
    vel_mode = sp.mode_xyz[..., 0] == MODE_VELOCITY
    vx_sp = torch.where(vel_mode, sp.vel[..., 0], vx_sp)
    vy_sp = torch.where(vel_mode, sp.vel[..., 1], vy_sp)
    vz_sp = torch.where(sp.mode_xyz[..., 2] == MODE_VELOCITY, sp.vel[..., 2],
                        vz_sp)

    # velocity PID -> raw roll/pitch (firmware velocityController)
    vel_x, roll_raw = _pid_update(state.vel_x, vx_sp - fw.vel[..., 0], dt,
                                  VX_KP, VX_KI, 0.0, 5000.0)
    vel_y, pitch_raw = _pid_update(state.vel_y, vy_sp - fw.vel[..., 1], dt,
                                   VX_KP, VX_KI, 0.0, 5000.0)
    yaw_rad = fw.rpy_deg[..., 2] * recip32(RAD_TO_DEG)
    cy, sy = torch.cos(yaw_rad), torch.sin(yaw_rad)
    pitch_des = torch.clamp(-(roll_raw * cy) - (pitch_raw * sy),
                            -RP_LIMIT, RP_LIMIT)
    roll_des = torch.clamp(-(pitch_raw * cy) + (roll_raw * sy),
                           -RP_LIMIT, RP_LIMIT)

    vel_z, thrust_raw = _pid_update(state.vel_z, vz_sp - fw.vel[..., 2], dt,
                                    VZ_KP, VZ_KI, 0.0, 5000.0)
    thrust = torch.clamp(thrust_raw * THRUST_SCALE + THRUST_BASE,
                         THRUST_MIN, 65535.0)
    att_des = torch.stack([roll_des, pitch_des,
                           state.att_desired_rpy[..., 2]], dim=-1)
    new = state._replace(pos_z=pos_z, vel_x=vel_x, vel_y=vel_y, vel_z=vel_z)
    return new, att_des, thrust


def _gate(run, new, old):
    return torch.where(_bcast(run, new), new, old)


def _gate_pid(run, new: Pid, old: Pid) -> Pid:
    return Pid(integ=torch.where(run, new.integ, old.integ),
               prev_error=torch.where(run, new.prev_error, old.prev_error))


def controller_pid(state: PidControllerState, sp: Setpoint, gyro_deg,
                   fw: FirmwareState, run_pos, run_att):
    """One firmware tick of ``controllerPid``, gated like the wrapper's
    tick (reference CFAviary._step_controller:388-416): ``run_pos`` -> the
    100 Hz position cascade, ``run_att`` -> the 500 Hz attitude cascade.
    Returns (new_state, control_rpyt)."""
    # ---- position cascade (100 Hz), only in position-abs mode -------------
    pos_state, att_from_pos, thrust_from_pos = _position_controller(
        state, sp, fw)
    pos_mode = sp.mode_xyz[..., 0] == MODE_ABS
    run_pos_eff = run_pos & pos_mode
    state = state._replace(
        pos_z=_gate_pid(run_pos_eff, pos_state.pos_z, state.pos_z),
        vel_x=_gate_pid(run_pos_eff, pos_state.vel_x, state.vel_x),
        vel_y=_gate_pid(run_pos_eff, pos_state.vel_y, state.vel_y),
        vel_z=_gate_pid(run_pos_eff, pos_state.vel_z, state.vel_z),
        att_desired_rpy=_gate(run_pos_eff, att_from_pos,
                              state.att_desired_rpy),
        actuator_thrust=torch.where(run_pos_eff, thrust_from_pos,
                                    state.actuator_thrust),
    )

    # attitude-mode passthroughs (mode.x disabled -> raw attitude setpoint)
    att_des = torch.where((sp.mode_xyz[..., 0] == MODE_DISABLE)[..., None],
                          sp.att_rpy, state.att_desired_rpy)
    thrust = torch.where(sp.mode_xyz[..., 2] == MODE_DISABLE, sp.thrust,
                         state.actuator_thrust)

    # ---- attitude cascade (500 Hz) -----------------------------------------
    dt = ATTITUDE_DT
    # desired attitude (from velocityController) and the state attitude
    # are both in the legacy frame (pitch inverted): compare directly
    roll_err = att_des[..., 0] - fw.rpy_deg[..., 0]
    pitch_err = att_des[..., 1] - fw.rpy_deg[..., 1]
    yaw_err = _wrap180(att_des[..., 2] - fw.rpy_deg[..., 2])
    att_roll, rate_roll_sp = _pid_update(
        state.att_roll, roll_err, dt, ROLL_KP, ROLL_KI, ROLL_KD, ROLL_ILIM)
    att_pitch, rate_pitch_sp = _pid_update(
        state.att_pitch, pitch_err, dt, PITCH_KP, PITCH_KI, PITCH_KD,
        PITCH_ILIM)
    att_yaw, rate_yaw_sp = _pid_update(
        state.att_yaw, yaw_err, dt, YAW_KP, YAW_KI, YAW_KD, YAW_ILIM)
    # rate-mode passthrough
    rate_roll_sp = torch.where(sp.mode_rpy[..., 0] == MODE_VELOCITY,
                               sp.att_rate[..., 0], rate_roll_sp)
    rate_pitch_sp = torch.where(sp.mode_rpy[..., 1] == MODE_VELOCITY,
                                sp.att_rate[..., 1], rate_pitch_sp)
    rate_yaw_sp = torch.where(sp.mode_rpy[..., 2] == MODE_VELOCITY,
                              sp.att_rate[..., 2], rate_yaw_sp)

    # rate PIDs on gyro (deg/s; gyro.y negated per controller_pid.c)
    rr, cmd_roll = _pid_update(
        state.rate_roll, rate_roll_sp - gyro_deg[..., 0], dt,
        RR_KP, RR_KI, RR_KD, RR_ILIM)
    pr, cmd_pitch = _pid_update(
        state.rate_pitch, rate_pitch_sp - (-gyro_deg[..., 1]), dt,
        PR_KP, PR_KI, PR_KD, PR_ILIM)
    yr, cmd_yaw = _pid_update(
        state.rate_yaw, rate_yaw_sp - gyro_deg[..., 2], dt,
        YR_KP, YR_KI, YR_KD, YR_ILIM)
    cmd_roll = torch.clamp(cmd_roll, -INT16_MAX, INT16_MAX)
    cmd_pitch = torch.clamp(cmd_pitch, -INT16_MAX, INT16_MAX)
    cmd_yaw = torch.clamp(-cmd_yaw, -INT16_MAX, INT16_MAX)  # negated yaw

    # zero-thrust safety: zero outputs and hold the integrators
    off = thrust < 1e-6
    cmd_roll = torch.where(off, 0.0, cmd_roll)
    cmd_pitch = torch.where(off, 0.0, cmd_pitch)
    cmd_yaw = torch.where(off, 0.0, cmd_yaw)

    new_control = torch.stack([cmd_roll, cmd_pitch, cmd_yaw, thrust], dim=-1)
    run = run_att & ~off
    state = state._replace(
        att_roll=_gate_pid(run, att_roll, state.att_roll),
        att_pitch=_gate_pid(run, att_pitch, state.att_pitch),
        att_yaw=_gate_pid(run, att_yaw, state.att_yaw),
        rate_roll=_gate_pid(run, rr, state.rate_roll),
        rate_pitch=_gate_pid(run, pr, state.rate_pitch),
        rate_yaw=_gate_pid(run, yr, state.rate_yaw),
        control_rpyt=_gate(run_att, new_control, state.control_rpyt),
        tick=state.tick + 1,
    )
    return state, state.control_rpyt
