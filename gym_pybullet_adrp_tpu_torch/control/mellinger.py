"""Crazyflie Mellinger firmware controller, object form, in plain PyTorch.

Counterpart of gym_pybullet_adrp_tpu.control.mellinger: the gains
(:40-64), ``lpf2p_coeffs``/``lpf2p_apply`` (:83-106), ``Setpoint`` and
``zero_setpoint`` (:112-138), ``FirmwareState``/``MellingerState`` and
``init_state`` (:141-197), the filter coefficients (:199-200),
``controller_mellinger`` (:207), ``compute_pwms`` (:417),
``pwms_to_rpm_with_disturbance`` (:433), ``update_sensor_and_state``
(:451), ``step_controller`` (:507) and ``compute_control`` (:553). The
general race env (envs/race.py) runs it per tick as eager tensor ops;
the window kernel (ops/race_window.py) carries its own transcription for
the packed path, as the JAX package's Pallas kernel does.

State lives in NamedTuples of tensors; every function broadcasts over
leading batch axes, ``(B, N, ...)`` in the envs. Where the JAX package
divides by a constant, the port multiplies by the float32 reciprocal of
the float32 constant (``recip32``): that is what XLA folds the division
into, so the tick gating fires on the same ticks.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..ops import quat as quat_ops
from ..utils.constants import (
    ACCEL_LPF_CUTOFF_FREQ, DEG_TO_RAD, FIRMWARE_DT, FIRMWARE_FREQ,
    GYRO_LPF_CUTOFF_FREQ, MAX_PWM, MIN_PWM, PWM2RPM_CONST, PWM2RPM_SCALE,
    RAD_TO_DEG, SENSOR_DELAY, SUPPLY_VOLTAGE,
)

# firmware gains (crazyflie-firmware controller_mellinger.c defaults)
GRAVITY_MAGNITUDE = 9.81  # firmware constant (differs from the sim's 9.8)
MASS = 0.032              # g_vehicleMass
MASS_THRUST = 132000.0

KP_XY = 0.4
KD_XY = 0.2
KI_XY = 0.05
I_RANGE_XY = 2.0

KP_Z = 1.25
KD_Z = 0.4
KI_Z = 0.05
I_RANGE_Z = 0.4

KR_XY = 70000.0
KW_XY = 20000.0
KI_M_XY = 0.0
I_RANGE_M_XY = 1.0

KR_Z = 60000.0
KW_Z = 12000.0
KI_M_Z = 500.0
I_RANGE_M_Z = 1500.0

KD_OMEGA_RP = 200.0

# setpoint mode flags (firmware stabilizer_types.h)
MODE_DISABLE = 0
MODE_ABS = 1
MODE_VELOCITY = 2


def recip32(c) -> float:
    """The float32 reciprocal of the float32 constant ``c``, as a Python
    float: ``x * recip32(c)`` is how XLA evaluates ``x / c``."""
    return float(np.float32(1.0) / np.float32(c))


# ---------------------------------------------------------------------------
# biquad low-pass filter (firmware filter.c lpf2p)


class Lpf2pState(NamedTuple):
    """Delay elements of a 2-pole butterworth LPF, per channel."""

    d1: torch.Tensor
    d2: torch.Tensor


def lpf2p_coeffs(sample_freq: float, cutoff_freq: float):
    """Static biquad coefficients (firmware lpf2pInit/lpf2pSetCutoffFreq),
    as plain Python floats."""
    fr = sample_freq / cutoff_freq
    ohm = np.tan(np.pi / fr)
    c = 1.0 + 2.0 * np.cos(np.pi / 4.0) * ohm + ohm * ohm
    b0 = ohm * ohm / c
    b1 = 2.0 * b0
    b2 = b0
    a1 = 2.0 * (ohm * ohm - 1.0) / c
    a2 = (1.0 - 2.0 * np.cos(np.pi / 4.0) * ohm + ohm * ohm) / c
    return float(b0), float(b1), float(b2), float(a1), float(a2)


def lpf2p_apply(coeffs, state: Lpf2pState, sample):
    """One filter step (firmware lpf2pApply). Broadcasts over channels."""
    b0, b1, b2, a1, a2 = coeffs
    d0 = sample - state.d1 * a1 - state.d2 * a2
    output = d0 * b0 + state.d1 * b1 + state.d2 * b2
    return Lpf2pState(d1=d0, d2=state.d1), output


# filter-assignment quirk preserved: the reference initializes the *accel*
# LPF with the GYRO cutoff and vice versa (MellingerControl.py:113-117)
_ACC_LPF_COEFFS = lpf2p_coeffs(FIRMWARE_FREQ, GYRO_LPF_CUTOFF_FREQ)
_GYRO_LPF_COEFFS = lpf2p_coeffs(FIRMWARE_FREQ, ACCEL_LPF_CUTOFF_FREQ)


# ---------------------------------------------------------------------------
# setpoint / firmware state structs


class Setpoint(NamedTuple):
    """firmware setpoint_t subset used by the Mellinger controller."""

    pos: torch.Tensor          # (..., 3)
    vel: torch.Tensor          # (..., 3)
    acc: torch.Tensor          # (..., 3)
    att_rpy: torch.Tensor      # (..., 3) deg
    att_rate: torch.Tensor     # (..., 3) deg/s
    att_quat: torch.Tensor     # (..., 4) xyzw
    thrust: torch.Tensor       # (...,)
    mode_xyz: torch.Tensor     # (..., 3) int32 (MODE_*)
    mode_rpy: torch.Tensor     # (..., 3) int32
    mode_quat: torch.Tensor    # (...,) int32


def zero_setpoint(shape=(), dtype=torch.float32, device="cuda") -> Setpoint:
    z3 = torch.zeros(shape + (3,), dtype=dtype, device=device)
    quat = torch.zeros(shape + (4,), dtype=dtype, device=device)
    quat[..., 3] = 1.0
    zi = torch.zeros(shape + (3,), dtype=torch.int32, device=device)
    return Setpoint(
        pos=z3, vel=z3.clone(), acc=z3.clone(), att_rpy=z3.clone(),
        att_rate=z3.clone(), att_quat=quat,
        thrust=torch.zeros(shape, dtype=dtype, device=device),
        mode_xyz=zi, mode_rpy=zi.clone(),
        mode_quat=torch.zeros(shape, dtype=torch.int32, device=device),
    )


class FirmwareState(NamedTuple):
    """firmware state_t subset (reference MellingerControl.py:446-471)."""

    pos: torch.Tensor        # (..., 3) m
    vel: torch.Tensor        # (..., 3) m/s
    acc: torch.Tensor        # (..., 3) Gs, z without gravity
    rpy_deg: torch.Tensor    # (..., 3) deg, legacy inverted pitch
    quat: torch.Tensor       # (..., 4) xyzw


class MellingerState(NamedTuple):
    """Controller integrals, D-term memory and wrapper bookkeeping."""

    i_error_pos: torch.Tensor      # (..., 3)
    i_error_m: torch.Tensor        # (..., 3)
    prev_omega_rp: torch.Tensor    # (..., 2) rad/s
    prev_setpoint_omega_rp: torch.Tensor  # (..., 2)
    control_rpyt: torch.Tensor     # (..., 4) held between gated ticks
    tick: torch.Tensor             # (...,) int32
    last_pos_pid_call: torch.Tensor  # (...,) s
    last_att_pid_call: torch.Tensor  # (...,) s
    tumble_counter: torch.Tensor   # (...,) int32
    error_flag: torch.Tensor       # (...,) bool
    prev_rpy: torch.Tensor         # (..., 3) rad
    prev_vel: torch.Tensor         # (..., 3)
    acc_lpf: Lpf2pState            # (..., 3)
    gyro_lpf: Lpf2pState           # (..., 3)
    # SENSOR_DELAY ring of [acc_body (3), gyro deg/s (3)], oldest first
    sensor_history: torch.Tensor   # (..., SENSOR_DELAY, 6)


def init_state(shape=(), dtype=torch.float32, device="cuda",
               sensor_delay: int = SENSOR_DELAY) -> MellingerState:
    def z(*d):
        return torch.zeros(shape + d, dtype=dtype, device=device)

    def zi():
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return MellingerState(
        i_error_pos=z(3), i_error_m=z(3), prev_omega_rp=z(2),
        prev_setpoint_omega_rp=z(2), control_rpyt=z(4), tick=zi(),
        last_pos_pid_call=z(), last_att_pid_call=z(), tumble_counter=zi(),
        error_flag=torch.zeros(shape, dtype=torch.bool, device=device),
        prev_rpy=z(3), prev_vel=z(3),
        acc_lpf=Lpf2pState(d1=z(3), d2=z(3)),
        gyro_lpf=Lpf2pState(d1=z(3), d2=z(3)),
        sensor_history=z(sensor_delay, 6),
    )


# ---------------------------------------------------------------------------
# control law


def _bcast(cond, like):
    """``cond`` with trailing unit axes up to ``like``'s rank."""
    return cond.reshape(cond.shape + (1,) * (like.dim() - cond.dim()))


def _safe_normalize(v):
    # forward-identical to v / max(norm(v), 1e-12) for every input, with
    # no sqrt(0) on the zero vector (the JAX package's double-where)
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = n2 < 1e-24
    n = torch.sqrt(torch.where(small, 1.0, n2))
    return v / torch.where(small, 1e-12, torch.clamp_min(n, 1e-12))


def controller_mellinger(state: MellingerState, setpoint: Setpoint,
                         gyro_deg, fw_state: FirmwareState, run):
    """One firmware control tick (controller_mellinger.c). ``gyro_deg``:
    LPF'd body rates, deg/s; ``run``: the tick gate (outputs and
    integrals are held where False). Returns (new_state, control_rpyt)."""
    dt = 1.0 / 500.0  # ATTITUDE_RATE
    inv_dt = recip32(dt)

    r_error = setpoint.pos - fw_state.pos
    v_error = setpoint.vel - fw_state.vel

    i_err = state.i_error_pos + r_error * dt
    i_err = torch.stack([
        torch.clamp(i_err[..., 0], -I_RANGE_XY, I_RANGE_XY),
        torch.clamp(i_err[..., 1], -I_RANGE_XY, I_RANGE_XY),
        torch.clamp(i_err[..., 2], -I_RANGE_Z, I_RANGE_Z),
    ], dim=-1)

    pos_mode = setpoint.mode_xyz[..., 0] == MODE_ABS
    tf_x = (MASS * setpoint.acc[..., 0] + KP_XY * r_error[..., 0]
            + KD_XY * v_error[..., 0] + KI_XY * i_err[..., 0])
    tf_y = (MASS * setpoint.acc[..., 1] + KP_XY * r_error[..., 1]
            + KD_XY * v_error[..., 1] + KI_XY * i_err[..., 1])
    tf_z = (MASS * (setpoint.acc[..., 2] + GRAVITY_MAGNITUDE)
            + KP_Z * r_error[..., 2] + KD_Z * v_error[..., 2]
            + KI_Z * i_err[..., 2])
    # attitude-only branch: with mode.z == modeAbs the altitude PID runs
    # without the acceleration feedforward, else the force z is 1
    alt_x = -torch.sin(setpoint.att_rpy[..., 1] * DEG_TO_RAD)
    alt_y = -torch.sin(setpoint.att_rpy[..., 0] * DEG_TO_RAD)
    alt_z = torch.where(
        setpoint.mode_xyz[..., 2] == MODE_ABS,
        MASS * GRAVITY_MAGNITUDE + KP_Z * r_error[..., 2]
        + KD_Z * v_error[..., 2] + KI_Z * i_err[..., 2],
        torch.ones_like(tf_z),
    )
    tt_x = torch.where(pos_mode, tf_x, alt_x)
    tt_y = torch.where(pos_mode, tf_y, alt_y)
    tt_z = torch.where(pos_mode, tf_z, alt_z)

    # desired yaw (deg): modeVelocity integrates the rate, modeAbs takes
    # the attitude, else the setpoint quaternion's (FULLSTATE)
    yaw_state = fw_state.rpy_deg[..., 2]
    yaw_vel = yaw_state + setpoint.att_rate[..., 2] * dt
    yaw_abs = setpoint.att_rpy[..., 2]
    yaw_quat = quat_ops.to_euler_xyz(setpoint.att_quat)[..., 2] * RAD_TO_DEG
    desired_yaw = torch.where(
        setpoint.mode_rpy[..., 2] == MODE_VELOCITY, yaw_vel,
        torch.where(setpoint.mode_rpy[..., 2] == MODE_ABS, yaw_abs,
                    torch.where(setpoint.mode_quat == MODE_ABS, yaw_quat,
                                0.0)))

    R = quat_ops.to_matrix(fw_state.quat)
    z_axis = R[..., :, 2]

    # yaw correction when not in position mode
    yaw_rad = fw_state.rpy_deg[..., 2] * DEG_TO_RAD
    cos_y, sin_y = torch.cos(yaw_rad), torch.sin(yaw_rad)
    x_corr = tt_x * cos_y - tt_y * sin_y
    y_corr = tt_x * sin_y + tt_y * cos_y
    target_thrust = torch.stack([
        torch.where(pos_mode, tt_x, x_corr),
        torch.where(pos_mode, tt_y, y_corr),
        tt_z,
    ], dim=-1)

    current_thrust = torch.sum(target_thrust * z_axis, dim=-1)

    z_axis_desired = _safe_normalize(target_thrust)
    x_c_des = torch.stack([
        torch.cos(desired_yaw * DEG_TO_RAD),
        torch.sin(desired_yaw * DEG_TO_RAD),
        torch.zeros_like(desired_yaw),
    ], dim=-1)
    y_axis_desired = _safe_normalize(quat_ops._cross(z_axis_desired,
                                                     x_c_des))
    x_axis_desired = quat_ops._cross(y_axis_desired, z_axis_desired)

    # attitude error eR from [Rdes^T R - R^T Rdes]
    Rdes = torch.stack([x_axis_desired, y_axis_desired, z_axis_desired],
                       dim=-1)
    eRM = Rdes.transpose(-1, -2) @ R - R.transpose(-1, -2) @ Rdes
    eR_x = eRM[..., 2, 1]
    eR_y = -eRM[..., 0, 2]
    eR_z = eRM[..., 1, 0]

    # angular velocity error (firmware sign quirks on pitch preserved)
    omega_roll = gyro_deg[..., 0] * DEG_TO_RAD
    omega_pitch = -gyro_deg[..., 1] * DEG_TO_RAD
    omega_yaw = gyro_deg[..., 2] * DEG_TO_RAD
    sp_omega_roll = setpoint.att_rate[..., 0] * DEG_TO_RAD
    sp_omega_pitch = setpoint.att_rate[..., 1] * DEG_TO_RAD
    ew_x = sp_omega_roll - omega_roll
    ew_y = -sp_omega_pitch - omega_pitch
    ew_z = setpoint.att_rate[..., 2] * DEG_TO_RAD - omega_yaw

    err_d_roll = ((sp_omega_roll - state.prev_setpoint_omega_rp[..., 0])
                  - (omega_roll - state.prev_omega_rp[..., 0])) * inv_dt
    err_d_pitch = ((-sp_omega_pitch - state.prev_setpoint_omega_rp[..., 1])
                   - (omega_pitch - state.prev_omega_rp[..., 1])) * inv_dt

    i_m = state.i_error_m + dt * torch.stack([-eR_x, -eR_y, -eR_z], dim=-1)
    i_m = torch.stack([
        torch.clamp(i_m[..., 0], -I_RANGE_M_XY, I_RANGE_M_XY),
        torch.clamp(i_m[..., 1], -I_RANGE_M_XY, I_RANGE_M_XY),
        torch.clamp(i_m[..., 2], -I_RANGE_M_Z, I_RANGE_M_Z),
    ], dim=-1)

    M_x = (-KR_XY * eR_x + KW_XY * ew_x + KI_M_XY * i_m[..., 0]
           + KD_OMEGA_RP * err_d_roll)
    M_y = (-KR_XY * eR_y + KW_XY * ew_y + KI_M_XY * i_m[..., 1]
           + KD_OMEGA_RP * err_d_pitch)
    M_z = -KR_Z * eR_z + KW_Z * ew_z + KI_M_Z * i_m[..., 2]

    thrust_out = torch.where(setpoint.mode_xyz[..., 2] == MODE_DISABLE,
                             setpoint.thrust, MASS_THRUST * current_thrust)
    pos_thrust = thrust_out > 0
    roll_out = torch.where(pos_thrust, torch.clamp(M_x, -32000.0, 32000.0),
                           0.0)
    pitch_out = torch.where(pos_thrust, torch.clamp(M_y, -32000.0, 32000.0),
                            0.0)
    yaw_out = torch.where(pos_thrust, torch.clamp(-M_z, -32000.0, 32000.0),
                          0.0)

    # on thrust <= 0 the firmware resets the controller
    reset = (~pos_thrust)[..., None]
    i_err = torch.where(reset, 0.0, i_err)
    i_m = torch.where(reset, 0.0, i_m)

    new_control = torch.stack([roll_out, pitch_out, yaw_out, thrust_out],
                              dim=-1)
    new_prev_omega = torch.stack([omega_roll, omega_pitch], dim=-1)
    new_prev_sp_omega = torch.stack([sp_omega_roll, -sp_omega_pitch], dim=-1)

    def sel(new, old):
        return torch.where(_bcast(run, new), new, old)

    new_state = state._replace(
        i_error_pos=sel(i_err, state.i_error_pos),
        i_error_m=sel(i_m, state.i_error_m),
        prev_omega_rp=sel(new_prev_omega, state.prev_omega_rp),
        prev_setpoint_omega_rp=sel(new_prev_sp_omega,
                                   state.prev_setpoint_omega_rp),
        control_rpyt=sel(new_control, state.control_rpyt),
    )
    return new_state, new_state.control_rpyt


# ---------------------------------------------------------------------------
# power distribution + motor conversions


def compute_pwms(control_rpyt):
    """control (roll, pitch, yaw, thrust) -> 4 motor pwms: X-formation
    mixer + brushed-motor voltage curve."""
    r = control_rpyt[..., 0] * 0.5
    p = control_rpyt[..., 1] * 0.5
    y = control_rpyt[..., 2]
    t = control_rpyt[..., 3]
    thrust = torch.stack([t - r + p + y, t - r - p - y, t + r - p + y,
                          t + r + p - y], dim=-1)
    thrust = torch.clamp(thrust, 0.0, MAX_PWM) * recip32(MAX_PWM) * 60.0
    volts = -0.0006239 * (thrust * thrust) + 0.088 * thrust
    percentage = torch.clamp_max(volts * recip32(SUPPLY_VOLTAGE), 1.0)
    return percentage * MAX_PWM


def pwms_to_rpm_with_disturbance(pwms, kf, disturbance):
    """Clip pwm -> rpm -> per-motor thrust, reorder [3, 2, 1, 0] for the
    IROS URDF, add the thrust-space disturbance, back through pwm to rpm
    (reference MellingerControl.computeControl:246-262)."""
    clipped = torch.clamp(pwms, MIN_PWM, MAX_PWM)
    r = PWM2RPM_SCALE * clipped + PWM2RPM_CONST
    thrust = kf * (r * r)
    thrust = torch.flip(thrust, dims=(-1,)) + disturbance
    thrust = torch.clamp_min(thrust, 0.0)
    motor_pwm = ((torch.sqrt(thrust / kf) - PWM2RPM_CONST)
                 * recip32(PWM2RPM_SCALE))
    motor_pwm = torch.clamp(motor_pwm, MIN_PWM, MAX_PWM)
    return PWM2RPM_SCALE * motor_pwm + PWM2RPM_CONST


# ---------------------------------------------------------------------------
# the wrapper's per-tick pipeline


def update_sensor_and_state(state: MellingerState, cur_pos, cur_rpy,
                            cur_vel):
    """Finite-difference rates/accel + LPF, filling the firmware structs.
    Returns (new_state, FirmwareState, gyro_deg filtered, acc filtered)."""
    inv_fdt = recip32(FIRMWARE_DT)
    up = torch.zeros_like(cur_vel)
    up[..., 2] = 1.0

    cur_rotation_rates = (cur_rpy - state.prev_rpy) * inv_fdt  # rad/s
    cur_acc = (cur_vel - state.prev_vel) * inv_fdt * recip32(9.8) + up

    q = quat_ops.from_euler_intrinsic_xyz(cur_rpy)
    acc_body = quat_ops.rotate_inv(q, cur_acc)
    gyro_deg_raw = cur_rotation_rates * RAD_TO_DEG

    # SENSOR_DELAY ring: feed the oldest sample, append the freshest
    sensor_history = state.sensor_history
    if sensor_history.shape[-2] > 0:
        delayed = sensor_history[..., 0, :]
        newest = torch.cat([acc_body, gyro_deg_raw], dim=-1)
        sensor_history = torch.cat([sensor_history[..., 1:, :],
                                    newest[..., None, :]], dim=-2)
        acc_body = delayed[..., 0:3]
        gyro_deg_raw = delayed[..., 3:6]

    acc_lpf, acc_f = lpf2p_apply(_ACC_LPF_COEFFS, state.acc_lpf, acc_body)
    gyro_lpf, gyro_f = lpf2p_apply(_GYRO_LPF_COEFFS, state.gyro_lpf,
                                   gyro_deg_raw)

    rpy_deg = cur_rpy * RAD_TO_DEG
    legacy = torch.cat([rpy_deg[..., :1], -rpy_deg[..., 1:2],
                        rpy_deg[..., 2:]], dim=-1)   # pitch inverted
    fw = FirmwareState(pos=cur_pos, vel=cur_vel, acc=cur_acc,
                       rpy_deg=legacy,
                       quat=quat_ops.from_euler_xyz(cur_rpy))
    new_state = state._replace(prev_rpy=cur_rpy, prev_vel=cur_vel,
                               acc_lpf=acc_lpf, gyro_lpf=gyro_lpf,
                               sensor_history=sensor_history)
    return new_state, fw, gyro_f, acc_f


def step_controller(state: MellingerState, setpoint: Setpoint,
                    fw: FirmwareState, gyro_deg, acc_gs):
    """Tick-gated controller step (reference _step_controller:378-419).
    Returns (new_state, pwms (..., 4))."""
    dtype = fw.pos.dtype
    # tumble check on the state acc (z in Gs, gravity-free)
    tumbling = fw.acc[..., 2] < -0.5
    tumble_counter = torch.where(tumbling, state.tumble_counter + 1,
                                 0).to(torch.int32)
    tumbled = tumble_counter >= 30

    cur_time = state.tick.to(dtype) * recip32(FIRMWARE_FREQ)
    att_due = cur_time - state.last_att_pid_call > 0.002
    pos_due = att_due & (cur_time - state.last_pos_pid_call > 0.01)
    # Mellinger runs the full law whenever the attitude loop fires
    new_state, control = controller_mellinger(
        state, setpoint, gyro_deg, fw, att_due & ~tumbled)

    # the tumble path returns before the tick-gating bookkeeping, so the
    # last-call stamps are held while tumbling
    new_state = new_state._replace(
        tick=state.tick + 1,
        tumble_counter=tumble_counter,
        error_flag=state.error_flag | tumbled,
        last_att_pid_call=torch.where(att_due & ~tumbled, cur_time,
                                      state.last_att_pid_call),
        last_pos_pid_call=torch.where(pos_due & ~tumbled, cur_time,
                                      state.last_pos_pid_call),
    )
    pwms = torch.where(tumbled[..., None], 0.0, compute_pwms(control))
    return new_state, pwms


def compute_control(state: MellingerState, setpoint: Setpoint, cur_pos,
                    cur_rpy, cur_vel, disturbance, kf=3.16e-10):
    """Sensors -> controller -> pwm -> rpm for one tick (reference
    MellingerControl.computeControl :154-262 without the setpoint update,
    which the commander does). Returns (new_state, rpm (..., 4))."""
    state, fw, gyro_deg, acc_gs = update_sensor_and_state(
        state, cur_pos, cur_rpy, cur_vel)
    state, pwms = step_controller(state, setpoint, fw, gyro_deg, acc_gs)
    return state, pwms_to_rpm_with_disturbance(pwms, kf, disturbance)
