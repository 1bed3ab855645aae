"""The plain PyTorch race step the benchmark holds the port's K5 rollout
against: a frozen copy, independent of the program.

Frozen from ``gym_pybullet_adrp_tpu_torch`` at commit f8ae565 (the
parent of the benchmark):

* ``window_consts``, ``_rsqrt``, ``_atan_core``, ``_atan``, ``_atan2``,
  ``_asin`` and ``window_loop_plain`` from ``ops/race_window.py``
  (:109-216, :239-622), with the poly7 planner's branches dropped: the
  fused step passes no planner coefficients, so they never run there;
* ``obs_channels``, ``tail_consts``, ``step_core_plain`` and
  ``tail_plain`` from ``ops/race_step.py`` (:69, :161-596);
* ``policy_forward_plain`` (ops/race_step.py:129), reading the weights
  from a dict of ``ActorCritic`` parameter names instead of the
  program's flat pack, with an optional lower precision for the control;
* the constants it reads from ``utils/constants.py``,
  ``control/mellinger.py`` (gains, ``lpf2p_coeffs``, ``recip32``) and
  ``models/drone.py`` (the CF2X entries).

Every op is the plain version's, in its order: the port's kernels are
built with ``-fmad=false`` and agree with that version to the bit on the
card, so the comparison that decides ``correct`` is exact. Blocks are
channel-major ``(C, T, 128)`` float32 rows, drone d of every env in rows
[d*Tb, (d+1)*Tb).
"""

import math
from types import SimpleNamespace

import numpy as np
import torch

LANE = 128
S_CHANNELS = 58
ACT_DIM = 4
LOG_2PI = math.log(2.0 * math.pi)

# utils/constants.py
RAD_TO_DEG = 180.0 / math.pi
RAD2DEG = 180.0 / math.pi
DEG2RAD = math.pi / 180.0
_PI = math.pi
VISIBILITY_RANGE = 0.45
FIRMWARE_FREQ = 500
CTRL_FREQ = 25
GYRO_LPF_CUTOFF_FREQ = 80.0
ACCEL_LPF_CUTOFF_FREQ = 30.0
GATE_Z_TALL = 1.0
GATE_Z_LOW = 0.525
GATE_RAY_HALF_LEN = 0.1875
GATE_OPENING_HALF = 0.225
GATE_BEAM_HALF = 0.025
GATE_EDGE_HALF_LEN = 0.25
GATE_SUPPORT_RADIUS = 0.05
GATE_SUPPORT_CENTER_DZ = -0.6
GATE_SUPPORT_HALF_LEN = 0.4
OBSTACLE_RADIUS = 0.05
OBSTACLE_HALF_LEN = 0.4

# models/drone.py: the CF2X entries the race reads, and the inertia base
CF2X = dict(kf=3.16e-10, km=7.94e-12, arm=0.0397, collision_h=0.025,
            collision_z_offset=0.0)
CF2X_LEGACY = dict(mass=0.027, J=(1.4e-5, 1.4e-5, 2.17e-5))


def recip32(c) -> float:
    """The float32 reciprocal of the float32 constant ``c``."""
    return float(np.float32(1.0) / np.float32(c))


def lpf2p_coeffs(sample_freq: float, cutoff_freq: float):
    """Static biquad coefficients (firmware lpf2pInit), Python floats."""
    fr = sample_freq / cutoff_freq
    ohm = np.tan(np.pi / fr)
    c = 1.0 + 2.0 * np.cos(np.pi / 4.0) * ohm + ohm * ohm
    b0 = ohm * ohm / c
    b1 = 2.0 * b0
    b2 = b0
    a1 = 2.0 * (ohm * ohm - 1.0) / c
    a2 = (1.0 - 2.0 * np.cos(np.pi / 4.0) * ohm + ohm * ohm) / c
    return float(b0), float(b1), float(b2), float(a1), float(a2)


# control/mellinger.py: firmware gains; the accel LPF takes the gyro
# cutoff and the gyro LPF the accel cutoff, as the firmware does
mel = SimpleNamespace(
    GRAVITY_MAGNITUDE=9.81, MASS=0.032, MASS_THRUST=132000.0,
    KP_XY=0.4, KD_XY=0.2, KI_XY=0.05, I_RANGE_XY=2.0,
    KP_Z=1.25, KD_Z=0.4, KI_Z=0.05, I_RANGE_Z=0.4,
    KR_XY=70000.0, KW_XY=20000.0, KI_M_XY=0.0, I_RANGE_M_XY=1.0,
    KR_Z=60000.0, KW_Z=12000.0, KI_M_Z=500.0, I_RANGE_M_Z=1500.0,
    KD_OMEGA_RP=200.0,
    _ACC_LPF_COEFFS=lpf2p_coeffs(FIRMWARE_FREQ, GYRO_LPF_CUTOFF_FREQ),
    _GYRO_LPF_COEFFS=lpf2p_coeffs(FIRMWARE_FREQ, ACCEL_LPF_CUTOFF_FREQ),
)


def window_consts(kf, km, arm, ground_z, dt, n_ticks):
    """Python-float constants of the window."""
    kf, km, arm, ground_z, dt = (float(v) for v in (kf, km, arm, ground_z,
                                                    dt))
    return dict(
        n_ticks=int(n_ticks),
        dt=dt,
        kf=kf,
        km=km,
        arm_s=float(arm / np.sqrt(2.0)),
        inv_dt=float(1.0 / dt),
        inv_dt_g=float(1.0 / dt / 9.8),
        ground_z=ground_z,
        qdt2=dt * dt * 0.25,
        hdt=dt * 0.5,
        inv_kf=1.0 / kf,
        tick_recip=recip32(1.0 / dt),
        acc=tuple(mel._ACC_LPF_COEFFS),
        gyro=tuple(mel._GYRO_LPF_COEFFS),
    )


# ops/race_window.py


def _rsqrt(x):
    """1/sqrt(x) with both steps correctly rounded (the kernel's form)."""
    return torch.ones_like(x) / torch.sqrt(x)


def _atan_core(x):
    """cephes atanf polynomial on |x| <= tan(pi/8)."""
    z = x * x
    return (
        (((8.05374449538e-2 * z - 1.38776856032e-1) * z + 1.99777106478e-1)
         * z - 3.33329491539e-1) * z * x + x
    )


def _atan(x):
    """Branchless float32 atan via cephes range reduction."""
    ax = torch.abs(x)
    big = ax > 2.414213562373095
    mid = ax > 0.4142135623730950
    num = torch.where(big, -1.0, torch.where(mid, ax - 1.0, ax))
    den = torch.where(
        big, torch.clamp_min(ax, 1e-30), torch.where(mid, ax + 1.0, 1.0)
    )
    xr = num / den
    base = torch.where(big, _PI / 2, torch.where(mid, _PI / 4, 0.0))
    y = base + _atan_core(xr)
    return torch.where(x < 0, -y, y)


def _atan2(y, x):
    ax = torch.where(torch.abs(x) > 1e-30, x, 1e-30)
    base = _atan(y / ax)
    shift = torch.where(y >= 0, _PI, -_PI)
    return torch.where(x < 0, base + shift, base)


def _asin(x):
    """cephes asinf polynomial."""
    x = torch.clamp(x, -1.0, 1.0)
    a = torch.abs(x)
    big = a > 0.5
    zz = torch.where(big, 0.5 * (1.0 - a), a * a)
    s = torch.where(big, torch.sqrt(zz), a)
    p = (
        ((((4.2163199048e-2 * zz + 2.4181311049e-2) * zz + 4.5470025998e-2)
          * zz + 7.4953002686e-2) * zz + 1.6666752422e-1) * zz * s + s
    )
    r = torch.where(big, _PI / 2 - 2.0 * p, p)
    return torch.where(x < 0, -r, r)



def window_loop_plain(S, wv, c, noise_rows=None):
    """The 20-tick firmware window over (58, T, 128) rows, the fused
    step's branch (no poly7 planner, a window-static desired yaw). ``wv``
    is the window-static dict ``step_core_plain`` builds and ``c`` is
    ``window_consts(...)``. Returns the final S block."""
    n_ticks, dt = c["n_ticks"], c["dt"]
    kf, km, arm_s = c["kf"], c["km"], c["arm_s"]
    inv_dt, inv_dt_g, ground_z = c["inv_dt"], c["inv_dt_g"], c["ground_z"]
    acc_b0, acc_b1, acc_b2, acc_a1, acc_a2 = c["acc"]
    gy_b0, gy_b1, gy_b2, gy_a1, gy_a2 = c["gyro"]

    sp_pos, sp_vel = wv["sp_pos"], wv["sp_vel"]
    sp_acc, sp_rate = wv["sp_acc"], wv["sp_rate"]
    sp_yaw_quat_deg, sp_thrust = wv["sp_yaw_quat_deg"], wv["sp_thrust"]
    pos_mode, z_disable = wv["pos_mode"], wv["z_disable"]
    eliminated, mass = wv["eliminated"], wv["mass"]
    Jx, Jy, Jz = wv["J"]
    inv_mass = torch.ones_like(mass) / mass
    inv_Jx = torch.ones_like(Jx) / Jx
    inv_Jy = torch.ones_like(Jy) / Jy
    inv_Jz = torch.ones_like(Jz) / Jz
    dy0 = sp_yaw_quat_deg * DEG2RAD
    xc_static = (torch.cos(dy0), torch.sin(dy0))

    def lpf(b0, b1, b2, a1, a2, d1, d2, x):
        d0 = x - d1 * a1 - d2 * a2
        out = d0 * b0 + d1 * b1 + d2 * b2
        return d0, d1, out

    st = [S[i] for i in range(S_CHANNELS)]
    for i in range(n_ticks):
        px, py, pz = st[0], st[1], st[2]
        qx, qy, qz, qw = st[3], st[4], st[5], st[6]
        vx, vy, vz = st[7], st[8], st[9]
        wx, wy, wz = st[10], st[11], st[12]
        rpm = [st[13], st[14], st[15], st[16]]

        # ---- 1. physics substep (PYB, CF2X) -------------------------------
        f = [r * r * kf for r in rpm]
        thrust = f[0] + f[1] + f[2] + f[3]
        tq = [r * r * km for r in rpm]
        tx = (f[0] + f[1] - f[2] - f[3]) * arm_s
        ty = (-f[0] + f[1] + f[2] - f[3]) * arm_s
        tz = tq[0] - tq[1] + tq[2] - tq[3]
        fx = 2.0 * (qx * qz + qy * qw) * thrust
        fy = 2.0 * (qy * qz - qx * qw) * thrust
        fz = (1.0 - 2.0 * (qx * qx + qy * qy)) * thrust
        if noise_rows is not None:
            tick_noise = noise_rows[i]
            fx = fx + tick_noise[0]
            fy = fy + tick_noise[1]
            fz = fz + tick_noise[2]
        vx = vx + dt * fx * inv_mass
        vy = vy + dt * fy * inv_mass
        vz = vz + dt * (fz * inv_mass - 9.8)
        wx = wx + dt * tx * inv_Jx
        wy = wy + dt * ty * inv_Jy
        wz = wz + dt * tz * inv_Jz
        px = px + dt * vx
        py = py + dt * vy
        pz = pz + dt * vz
        r00 = 1.0 - 2.0 * (qy * qy + qz * qz)
        r01 = 2.0 * (qx * qy - qz * qw)
        r02 = 2.0 * (qx * qz + qy * qw)
        r10 = 2.0 * (qx * qy + qz * qw)
        r11 = 1.0 - 2.0 * (qx * qx + qz * qz)
        r12 = 2.0 * (qy * qz - qx * qw)
        r20 = 2.0 * (qx * qz - qy * qw)
        r21 = 2.0 * (qy * qz + qx * qw)
        r22 = 1.0 - 2.0 * (qx * qx + qy * qy)
        ox = r00 * wx + r01 * wy + r02 * wz
        oy = r10 * wx + r11 * wy + r12 * wz
        oz = r20 * wx + r21 * wy + r22 * wz
        # sinc-form small-angle quaternion update (7th-order series)
        n2 = ox * ox + oy * oy + oz * oz
        t2 = n2 * c["qdt2"]
        t4 = t2 * t2
        t6 = t4 * t2
        s_n = c["hdt"] * (
            1.0 - t2 * (1.0 / 6.0) + t4 * (1.0 / 120.0) - t6 * (1.0 / 5040.0)
        )
        cth = 1.0 - t2 * 0.5 + t4 * (1.0 / 24.0) - t6 * (1.0 / 720.0)
        ux, uy, uz = ox * s_n, oy * s_n, oz * s_n
        nqx = cth * qx + qw * ux + (uy * qz - uz * qy)
        nqy = cth * qy + qw * uy + (uz * qx - ux * qz)
        nqz = cth * qz + qw * uz + (ux * qy - uy * qx)
        nqw = cth * qw - (ux * qx + uy * qy + uz * qz)
        keep = n2 <= 1e-16
        qx = torch.where(keep, qx, nqx)
        qy = torch.where(keep, qy, nqy)
        qz = torch.where(keep, qz, nqz)
        qw = torch.where(keep, qw, nqw)
        below = pz < ground_z
        pz = torch.where(below, ground_z, pz)
        vx = torch.where(below, 0.0, vx)
        vy = torch.where(below, 0.0, vy)
        vz = torch.where(below, torch.clamp_min(vz, 0.0), vz)
        wx = torch.where(below, 0.0, wx)
        wy = torch.where(below, 0.0, wy)
        wz = torch.where(below, 0.0, wz)

        sinr = 2.0 * (qw * qx + qy * qz)
        cosr = 1.0 - 2.0 * (qx * qx + qy * qy)
        roll = _atan2(sinr, cosr)
        sinp = torch.clamp(2.0 * (qw * qy - qz * qx), -1.0, 1.0)
        pitch = _asin(sinp)
        siny = 2.0 * (qw * qz + qx * qy)
        cosy_r = 1.0 - 2.0 * (qy * qy + qz * qz)
        yaw = _atan2(siny, cosy_r)
        cp2 = torch.clamp_min(1.0 - sinp * sinp, 1e-12)
        inv_cp = _rsqrt(cp2)
        cp = cp2 * inv_cp
        sp_ = sinp
        cyw = cosy_r * inv_cp
        syw = siny * inv_cp
        cr = cosr * inv_cp
        sr = sinr * inv_cp

        # ---- 2. commander per-tick setpoint -------------------------------
        tick = st[53]
        spx, spy, spz = sp_pos
        svx, svy, svz = sp_vel
        sax, say, saz = sp_acc
        srx, sry, srz = sp_rate

        # ---- 3. Mellinger sensors ------------------------------------------
        prev_r, prev_p, prev_y = st[21], st[22], st[23]
        pvx, pvy, pvz = st[24], st[25], st[26]
        rate_r = (roll - prev_r) * inv_dt
        rate_p = (pitch - prev_p) * inv_dt
        rate_y = (yaw - prev_y) * inv_dt
        accx = (vx - pvx) * inv_dt_g
        accy = (vy - pvy) * inv_dt_g
        accz = (vz - pvz) * inv_dt_g + 1.0
        a00 = cp * cyw
        a01 = -cp * syw
        a02 = sp_
        a10 = cr * syw + sr * sp_ * cyw
        a11 = cr * cyw - sr * sp_ * syw
        a12 = -sr * cp
        a20 = sr * syw - cr * sp_ * cyw
        a21 = sr * cyw + cr * sp_ * syw
        a22 = cr * cp
        ab_x = a00 * accx + a10 * accy + a20 * accz
        ab_y = a01 * accx + a11 * accy + a21 * accz
        ab_z = a02 * accx + a12 * accy + a22 * accz

        acc_d1 = [st[27], st[28], st[29]]
        acc_d2 = [st[30], st[31], st[32]]
        gy_d1 = [st[33], st[34], st[35]]
        gy_d2 = [st[36], st[37], st[38]]
        acc_f = []
        for k, x in enumerate((ab_x, ab_y, ab_z)):
            nd1, nd2, out = lpf(acc_b0, acc_b1, acc_b2, acc_a1, acc_a2,
                                acc_d1[k], acc_d2[k], x)
            acc_d1[k], acc_d2[k] = nd1, nd2
            acc_f.append(out)
        gyro_f = []
        for k, x in enumerate(
                (rate_r * RAD2DEG, rate_p * RAD2DEG, rate_y * RAD2DEG)):
            nd1, nd2, out = lpf(gy_b0, gy_b1, gy_b2, gy_a1, gy_a2,
                                gy_d1[k], gy_d2[k], x)
            gy_d1[k], gy_d2[k] = nd1, nd2
            gyro_f.append(out)

        # ---- 4. tick gating + tumble --------------------------------------
        tumbling = accz < -0.5
        tumble_counter = torch.where(tumbling, st[56] + 1.0, 0.0)
        tumbled = tumble_counter >= 30.0
        cur_time = tick * c["tick_recip"]
        att_due = cur_time - st[55] > 0.002
        pos_due = att_due & (cur_time - st[54] > 0.01)
        run = att_due & ~tumbled

        # ---- 5. Mellinger control law -------------------------------------
        m_dt = 1.0 / 500.0
        r_err = (spx - px, spy - py, spz - pz)
        v_err = (svx - vx, svy - vy, svz - vz)
        i_ep = [st[39], st[40], st[41]]
        i_ep[0] = torch.clamp(i_ep[0] + r_err[0] * m_dt,
                              -mel.I_RANGE_XY, mel.I_RANGE_XY)
        i_ep[1] = torch.clamp(i_ep[1] + r_err[1] * m_dt,
                              -mel.I_RANGE_XY, mel.I_RANGE_XY)
        i_ep[2] = torch.clamp(i_ep[2] + r_err[2] * m_dt,
                              -mel.I_RANGE_Z, mel.I_RANGE_Z)

        tf_x = (mel.MASS * sax + mel.KP_XY * r_err[0]
                + mel.KD_XY * v_err[0] + mel.KI_XY * i_ep[0])
        tf_y = (mel.MASS * say + mel.KP_XY * r_err[1]
                + mel.KD_XY * v_err[1] + mel.KI_XY * i_ep[1])
        tf_z = (
            mel.MASS * (saz + mel.GRAVITY_MAGNITUDE)
            + mel.KP_Z * r_err[2] + mel.KD_Z * v_err[2] + mel.KI_Z * i_ep[2]
        )
        t0_ = torch.where(pos_mode, tf_x, 0.0)
        t1_ = torch.where(pos_mode, tf_y, 0.0)
        t2_ = torch.where(pos_mode, tf_z, 1.0)
        t0 = torch.where(pos_mode, t0_, t0_ * cyw - t1_ * syw)
        t1 = torch.where(pos_mode, t1_, t0_ * syw + t1_ * cyw)
        t2 = t2_

        c0x, c0y, c0z = cyw * cp, syw * cp, -sp_
        c1x = cyw * sp_ * sr - syw * cr
        c1y = syw * sp_ * sr + cyw * cr
        c1z = cp * sr
        c2x = cyw * sp_ * cr + syw * sr
        c2y = syw * sp_ * cr - cyw * sr
        c2z = cp * cr
        current_thrust = t0 * c2x + t1 * c2y + t2 * c2z

        inv_t = _rsqrt(torch.clamp_min(t0 * t0 + t1 * t1 + t2 * t2, 1e-24))
        zdx, zdy, zdz = t0 * inv_t, t1 * inv_t, t2 * inv_t
        xcx, xcy = xc_static
        ydx = zdy * 0.0 - zdz * xcy
        ydy = zdz * xcx - zdx * 0.0
        ydz = zdx * xcy - zdy * xcx
        inv_y = _rsqrt(
            torch.clamp_min(ydx * ydx + ydy * ydy + ydz * ydz, 1e-24)
        )
        ydx, ydy, ydz = ydx * inv_y, ydy * inv_y, ydz * inv_y
        xdx = ydy * zdz - ydz * zdy
        xdy = ydz * zdx - ydx * zdz
        xdz = ydx * zdy - ydy * zdx

        def dot3(ax, ay, az, bx, by, bz):
            return ax * bx + ay * by + az * bz

        eR_x = (dot3(zdx, zdy, zdz, c1x, c1y, c1z)
                - dot3(ydx, ydy, ydz, c2x, c2y, c2z))
        eR_y = -(dot3(xdx, xdy, xdz, c2x, c2y, c2z)
                 - dot3(zdx, zdy, zdz, c0x, c0y, c0z))
        eR_z = (dot3(ydx, ydy, ydz, c0x, c0y, c0z)
                - dot3(xdx, xdy, xdz, c1x, c1y, c1z))

        om_r = gyro_f[0] * DEG2RAD
        om_p = -gyro_f[1] * DEG2RAD
        om_y = gyro_f[2] * DEG2RAD
        sp_om_r = srx * DEG2RAD
        sp_om_p = sry * DEG2RAD
        ew_x = sp_om_r - om_r
        ew_y = -sp_om_p - om_p
        ew_z = srz * DEG2RAD - om_y
        inv_m_dt = 1.0 / m_dt
        err_d_roll = ((sp_om_r - st[47]) - (om_r - st[45])) * inv_m_dt
        err_d_pitch = ((-sp_om_p - st[48]) - (om_p - st[46])) * inv_m_dt

        i_m = [st[42], st[43], st[44]]
        i_m[0] = torch.clamp(i_m[0] - eR_x * m_dt,
                             -mel.I_RANGE_M_XY, mel.I_RANGE_M_XY)
        i_m[1] = torch.clamp(i_m[1] - eR_y * m_dt,
                             -mel.I_RANGE_M_XY, mel.I_RANGE_M_XY)
        i_m[2] = torch.clamp(i_m[2] - eR_z * m_dt,
                             -mel.I_RANGE_M_Z, mel.I_RANGE_M_Z)

        M_x = (-mel.KR_XY * eR_x + mel.KW_XY * ew_x + mel.KI_M_XY * i_m[0]
               + mel.KD_OMEGA_RP * err_d_roll)
        M_y = (-mel.KR_XY * eR_y + mel.KW_XY * ew_y + mel.KI_M_XY * i_m[1]
               + mel.KD_OMEGA_RP * err_d_pitch)
        M_z = -mel.KR_Z * eR_z + mel.KW_Z * ew_z + mel.KI_M_Z * i_m[2]

        thrust_out = torch.where(
            z_disable, sp_thrust, mel.MASS_THRUST * current_thrust
        )
        pos_thrust = thrust_out > 0
        roll_out = torch.where(pos_thrust,
                               torch.clamp(M_x, -32000.0, 32000.0), 0.0)
        pitch_out = torch.where(pos_thrust,
                                torch.clamp(M_y, -32000.0, 32000.0), 0.0)
        yaw_out = torch.where(pos_thrust,
                              torch.clamp(-M_z, -32000.0, 32000.0), 0.0)
        reset_m = ~pos_thrust
        for k in range(3):
            i_ep[k] = torch.where(reset_m, 0.0, i_ep[k])
            i_m[k] = torch.where(reset_m, 0.0, i_m[k])

        def sel(new, old):
            return torch.where(run, new, old)

        ctl_r = sel(roll_out, st[49])
        ctl_p = sel(pitch_out, st[50])
        ctl_y = sel(yaw_out, st[51])
        ctl_t = sel(thrust_out, st[52])
        i_ep = [sel(i_ep[k], st[39 + k]) for k in range(3)]
        i_m = [sel(i_m[k], st[42 + k]) for k in range(3)]
        new_prev_om_r = sel(om_r, st[45])
        new_prev_om_p = sel(om_p, st[46])
        new_prev_sp_r = sel(sp_om_r, st[47])
        new_prev_sp_p = sel(-sp_om_p, st[48])

        # ---- 6. power distribution + motor pipeline -----------------------
        r2 = ctl_r * 0.5
        p2 = ctl_p * 0.5
        mth = [
            ctl_t - r2 + p2 + ctl_y,
            ctl_t - r2 - p2 - ctl_y,
            ctl_t + r2 - p2 + ctl_y,
            ctl_t + r2 + p2 - ctl_y,
        ]
        k_in = 60.0 / 65535.0
        kq = -0.0006239 * k_in * k_in * (65535.0 / 3.0)
        kl = 0.088 * k_in * (65535.0 / 3.0)
        pwms = []
        for v in mth:
            cl = torch.clamp(v, 0.0, 65535.0)
            pwms.append(torch.clamp_max((kq * cl + kl) * cl, 65535.0))
        pwms = [torch.where(tumbled, 0.0, v) for v in pwms]
        rpms_out = []
        for v in pwms:
            cl = torch.clamp(v, 20000.0, 65535.0)
            rpms_out.append(0.2685 * cl + 4070.3)
        if noise_rows is None:
            # the thrust round trip is the identity without noise: only
            # the [3,2,1,0] motor reorder survives
            new_rpm = rpms_out[::-1]
        else:
            thr = [kf * r * r for r in rpms_out][::-1]
            for m in range(4):
                thr[m] = thr[m] + tick_noise[3 + m]
            new_rpm = []
            for t_m in thr:
                mp = ((torch.sqrt(torch.clamp_min(t_m, 0.0) * c["inv_kf"])
                       - 4070.3) * (1.0 / 0.2685))
                mp = torch.clamp(mp, 20000.0, 65535.0)
                new_rpm.append(0.2685 * mp + 4070.3)
        new_rpm = [torch.where(eliminated, 0.0, r) for r in new_rpm]
        prev_rpms = [torch.where(eliminated, 0.0, r) for r in rpm]

        new_tick = tick + 1.0
        new_last_att = torch.where(att_due & ~tumbled, cur_time, st[55])
        new_last_pos = torch.where(pos_due & ~tumbled, cur_time, st[54])
        new_err = torch.where(tumbled, 1.0, st[57])

        st = [
            px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz,
            new_rpm[0], new_rpm[1], new_rpm[2], new_rpm[3],
            prev_rpms[0], prev_rpms[1], prev_rpms[2], prev_rpms[3],
            roll, pitch, yaw, vx, vy, vz,
            acc_d1[0], acc_d1[1], acc_d1[2],
            acc_d2[0], acc_d2[1], acc_d2[2],
            gy_d1[0], gy_d1[1], gy_d1[2],
            gy_d2[0], gy_d2[1], gy_d2[2],
            i_ep[0], i_ep[1], i_ep[2],
            i_m[0], i_m[1], i_m[2],
            new_prev_om_r, new_prev_om_p,
            new_prev_sp_r, new_prev_sp_p,
            ctl_r, ctl_p, ctl_y, ctl_t,
            new_tick, new_last_pos, new_last_att, tumble_counter,
            new_err,
        ]
    return torch.stack(st, dim=0)

def obs_channels(N, G, O, compete):
    return 12 + 5 * G + 4 * O + 1 + (6 * (N - 1) if compete and N > 1 else 0)


# ---------------------------------------------------------------------------
# the policy forward and Gaussian sample


def policy_forward_plain(weights, obs_rows, actn, dtype=torch.float32):
    """The in-kernel ActorCritic forward and sample over (C, T, 128) obs
    rows and (4, T, 128) standard-normal draws. ``weights`` maps the
    ``ActorCritic`` parameter names (``pi.0.weight`` (H1, C), ...,
    ``vf_out.bias`` (1,), ``log_std`` (4,)) to tensors. Every dot product
    accumulates over the inner dimension in ascending order from 0 and
    adds the bias last, as the kernel does. Returns (ACT unclipped (4, T,
    128), LOGP (T, 128), VAL (T, 128)) in float32.

    ``dtype`` below float32 (the control) rounds the weights, the obs and
    every intermediate of the two towers to it; the sample and its
    log-probability stay in float32."""

    def dense(name, x, act):
        W = weights[name + ".weight"].to(dtype)
        b = weights[name + ".bias"].to(dtype)
        out, inn = W.shape
        acc = torch.zeros((out,) + tuple(x.shape[1:]), dtype=dtype,
                          device=x.device)
        for i in range(inn):
            acc = acc + W[:, i, None, None] * x[i]
        v = acc + b[:, None, None]
        return torch.tanh(v) if act else v

    x = obs_rows.to(dtype)
    h = dense("pi.0", x, True)
    h = dense("pi.1", h, True)
    mean = dense("pi_out", h, False).to(torch.float32)
    v = dense("vf.0", x, True)
    v = dense("vf.1", v, True)
    val = dense("vf_out", v, False)[0].to(torch.float32)
    log_std = weights["log_std"].to(torch.float32)[:, None, None]
    act = mean + torch.exp(log_std) * actn
    contrib = -0.5 * (actn * actn + 2.0 * log_std + LOG_2PI)
    logp = contrib[0] + contrib[1] + contrib[2] + contrib[3]
    return act, logp, val


# ---------------------------------------------------------------------------
# the control-rate tail and the step


def tail_consts(spec_tail, ground_z):
    """Constants of the control-rate tail as Python floats, each folded
    as ``_step_core`` folds it: in double precision where the JAX kernel
    combines Python constants, in float32 where it combines a float32 gate
    coordinate with one, and as a float32 reciprocal where it divides by a
    constant."""
    (N, Tb, G, O, gates, obstacles, bounds_hi, heights, compete,
     per_drone_reward, end_after_gate, done_on_collision,
     done_on_completion, episode_len_sec, pyb_freq, drone_r,
     half_h) = spec_tail
    gates = np.asarray(gates, dtype=np.float32)
    obstacles = np.asarray(obstacles, dtype=np.float32)
    drone_r, half_h = float(drone_r), float(half_h)
    return dict(
        N=int(N), Tb=int(Tb), G=int(G), O=int(O),
        compete=bool(compete) and int(N) > 1,
        per_drone_reward=bool(per_drone_reward),
        end_after_gate=int(end_after_gate),
        done_on_collision=bool(done_on_collision),
        done_on_completion=bool(done_on_completion),
        episode_len_sec=float(episode_len_sec),
        pyb_freq=float(pyb_freq),
        inv_freq=recip32(pyb_freq),
        inv_G=recip32(G),
        inv_ray=recip32(0.05),
        bounds_hi=tuple(float(v) for v in bounds_hi),
        dr2=drone_r * drone_r,
        edge_dr=GATE_EDGE_HALF_LEN + drone_r,
        beam_dr=GATE_BEAM_HALF + drone_r,
        beam_hh=GATE_BEAM_HALF + half_h,
        edge_hh=GATE_EDGE_HALF_LEN + half_h,
        sup_dr=GATE_SUPPORT_RADIUS + drone_r,
        obst_dr=OBSTACLE_RADIUS + drone_r,
        half_h=half_h,
        ground_eps=float(ground_z) + 1e-6,
        dd_r2=(2.0 * drone_r) ** 2,
        dd_hz=2.0 * half_h,
        # per gate
        h_lo=[float(h) - GATE_RAY_HALF_LEN for h in heights],
        h_hi=[float(h) + GATE_RAY_HALF_LEN for h in heights],
        gz=[float(gates[g, 2]) for g in range(G)],
        sup_lo=[float(gates[g, 2] + GATE_SUPPORT_CENTER_DZ
                      - GATE_SUPPORT_HALF_LEN) for g in range(G)],
        sup_hi=[float(gates[g, 2] + GATE_SUPPORT_CENTER_DZ
                      + GATE_SUPPORT_HALF_LEN) for g in range(G)],
        g_nom=[tuple(float(v) for v in gates[g, [0, 1, 2, 5]])
               for g in range(G)],
        # per obstacle
        o_lo=[float(obstacles[o, 2] - OBSTACLE_HALF_LEN) for o in range(O)],
        o_hi=[float(obstacles[o, 2] + OBSTACLE_HALF_LEN) for o in range(O)],
        o_nom=[tuple(float(v) for v in obstacles[o, :3]) for o in range(O)],
    )


# ---------------------------------------------------------------------------
# plain PyTorch version


def step_core_plain(wc, tc, S0, A, Rb, gg, oo, ep_steps0, rst, gates_reset,
                    obst_reset, noise_rows=None, telemetry=False,
                    elim_penalty=1.0, policy=None):
    """One env step over plain tensors; transcribes ``_step_core``.
    ``wc``/``tc`` are ``window_consts(...)`` and ``tail_consts(...)``.
    With ``policy`` = (obs_rows, weights, actn, dtype) the policy forward
    and sample run first, ``A`` is ignored and the outputs gain ACT, LOGP
    and VAL. Returns a dict of output blocks."""
    # ---- 0. the policy forward and sample ----------------------------------
    pol = None
    if policy is not None:
        obs_in, weights, actn, dtype = policy
        pol = policy_forward_plain(weights, obs_in, actn, dtype)
        # the clipped action drives the step (yaw x pi is not read)
        A = torch.clamp(pol[0], -1.0, 1.0)
    # ---- 1. window statics from the FULLSTATE action -----------------------
    elim0 = Rb[1]
    px0, py0, pz0 = S0[0], S0[1], S0[2]
    yaw0 = S0[23]
    z = torch.zeros_like(px0)
    alive = elim0 < 0.5
    wv = dict(
        sp_pos=(px0 + A[0], py0 + A[1], pz0 + A[2]),
        sp_vel=(z, z, z), sp_acc=(z, z, z), sp_rate=(z, z, z),
        sp_yaw_quat_deg=yaw0 * RAD_TO_DEG,
        sp_thrust=z,
        pos_mode=alive, z_disable=~alive, eliminated=~alive,
        mass=Rb[10], J=(Rb[11], Rb[12], Rb[13]),
    )

    # ---- 2. the firmware window ---------------------------------------------
    S = window_loop_plain(S0, wv, wc, noise_rows=noise_rows)
    out = tail_plain(tc, wc["n_ticks"], S, Rb, gg, oo, ep_steps0, rst,
                     gates_reset, obst_reset, telemetry=telemetry,
                     elim_penalty=elim_penalty)
    if pol is not None:
        out["ACT"], out["LOGP"], out["VAL"] = pol
    return out


def tail_plain(tc, n_ticks, S, Rb, gg, oo, ep_steps0, rst, gates_reset,
               obst_reset, telemetry=False, elim_penalty=1.0):
    """The control-rate tail over the post-window S block (mirrors
    race_rl_rowfast.row_tail and the rest of the JAX row step): gate
    progress, collisions, visibility, termination, shaping, observation
    and autoreset. Returns the dict of output blocks."""
    N, Tb, G, O = tc["N"], tc["Tb"], tc["G"], tc["O"]
    compete = tc["compete"]

    def _d(x, d):
        return x[d * Tb:(d + 1) * Tb]

    def _env_rows(x):
        return x if N == 1 else torch.cat([x] * N, dim=0)

    # ---- 3. ctrl-rate tail ----------------------------------------------------
    px, py, pz = S[0], S[1], S[2]
    roll, pitch, yaw = S[21], S[22], S[23]
    vx, vy, vz = S[7], S[8], S[9]
    qx, qy, qz, qw = S[3], S[4], S[5], S[6]
    wx, wy, wz = S[10], S[11], S[12]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qz * qw)
    r02 = 2 * (qx * qz + qy * qw)
    r10 = 2 * (qx * qy + qz * qw)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qx * qw)
    r20 = 2 * (qx * qz - qy * qw)
    r21 = 2 * (qy * qz + qx * qw)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    ox_w = r00 * wx + r01 * wy + r02 * wz
    oy_w = r10 * wx + r11 * wy + r12 * wz
    oz_w = r20 * wx + r21 * wy + r22 * wz

    gx_a = [_env_rows(gg[3 * g + 0]) for g in range(G)]
    gy_a = [_env_rows(gg[3 * g + 1]) for g in range(G)]
    gyaw_a = [_env_rows(gg[3 * g + 2]) for g in range(G)]
    gcos = [torch.cos(v) for v in gyaw_a]
    gsin = [torch.sin(v) for v in gyaw_a]
    ox_a = [_env_rows(oo[2 * o]) for o in range(O)]
    oy_a = [_env_rows(oo[2 * o + 1]) for o in range(O)]
    f32 = px.dtype

    current_gate0 = Rb[0]
    finished = torch.maximum(Rb[2], (current_gate0 >= G).to(f32))
    passed_any = torch.zeros_like(px)
    for g in range(G):
        c, s = gcos[g], gsin[g]
        relx, rely = px - gx_a[g], py - gy_a[g]
        along = relx * c + rely * s
        perp = torch.abs(-relx * s + rely * c)
        dz_lo = tc["h_lo"][g] - pz
        dz_hi = pz - tc["h_hi"][g]
        dz_out = torch.clamp_min(torch.maximum(dz_lo, dz_hi), 0.0)
        i_near = torch.clamp(torch.round(along * tc["inv_ray"]), -3.0, 3.0)
        d_lat = torch.abs(along - i_near * 0.05)
        dist2 = perp * perp + d_lat * d_lat + dz_out * dz_out
        hit = dist2 < tc["dr2"]
        passed_any = passed_any + hit.to(f32) * (current_gate0 == g).to(f32)
    in_prog = (current_gate0 < G).to(f32)
    current_gate = current_gate0 + torch.clamp_max(passed_any, 1.0) * in_prog

    crash = torch.zeros_like(px, dtype=torch.bool)
    for g in range(G):
        gz_ = tc["gz"][g]
        c, s = gcos[g], gsin[g]
        relx, rely = px - gx_a[g], py - gy_a[g]
        along = relx * c + rely * s
        perp = torch.abs(-relx * s + rely * c)
        dzc = pz - gz_
        within = torch.abs(along) < tc["edge_dr"]
        horiz = within & (perp < tc["beam_dr"]) & (
            (torch.abs(dzc - GATE_OPENING_HALF) < tc["beam_hh"])
            | (torch.abs(dzc + GATE_OPENING_HALF) < tc["beam_hh"])
        )
        vert = (perp < tc["beam_dr"]) & (
            (torch.abs(along - GATE_OPENING_HALF) < tc["beam_dr"])
            | (torch.abs(along + GATE_OPENING_HALF) < tc["beam_dr"])
        ) & (torch.abs(dzc) < tc["edge_hh"])
        dxy = torch.sqrt(relx * relx + rely * rely)
        sup = (
            (dxy < tc["sup_dr"])
            & (pz - tc["half_h"] < tc["sup_hi"][g])
            & (pz + tc["half_h"] > tc["sup_lo"][g])
        )
        crash = crash | horiz | vert | sup
    for o in range(O):
        dx, dy = px - ox_a[o], py - oy_a[o]
        dxy = torch.sqrt(dx * dx + dy * dy)
        crash = crash | (
            (dxy < tc["obst_dr"])
            & (pz - tc["half_h"] < tc["o_hi"][o])
            & (pz + tc["half_h"] > tc["o_lo"][o])
        )
    crash = crash | (pz <= tc["ground_eps"])
    if compete:
        dd = []
        for d in range(N):
            hit_d = torch.zeros_like(_d(px, d), dtype=torch.bool)
            for e in range(N):
                if e == d:
                    continue
                ddx = _d(px, d) - _d(px, e)
                ddy = _d(py, d) - _d(py, e)
                dxy2 = ddx * ddx + ddy * ddy
                hit_d = hit_d | (
                    (dxy2 < tc["dd_r2"])
                    & (torch.abs(_d(pz, d) - _d(pz, e)) < tc["dd_hz"])
                )
            dd.append(hit_d)
        crash = crash | torch.cat(dd, dim=0)
    if not tc["done_on_collision"]:
        crash = torch.zeros_like(crash)
    bx, by, bz = tc["bounds_hi"]
    oob = (torch.abs(px) > bx) | (torch.abs(py) > by) | (torch.abs(pz) > bz)
    unstable = ((torch.abs(ox_w) > 20.0) | (torch.abs(oy_w) > 20.0)
                | (torch.abs(oz_w) > 20.0))
    eliminated = torch.maximum(Rb[1], (crash | oob | unstable).to(f32))

    # visibility (exact min over the 5 frame capsules)
    e_half, hb = GATE_EDGE_HALF_LEN, GATE_BEAM_HALF
    gate_range = []
    for g in range(G):
        c, s = gcos[g], gsin[g]
        relx, rely = px - gx_a[g], py - gy_a[g]
        along = relx * c + rely * s
        perp = -relx * s + rely * c
        dzc = pz - tc["gz"][g]
        a_cl = torch.clamp(along, -e_half, e_half)
        da = along - a_cl
        dt_ = dzc - GATE_OPENING_HALF
        db_ = dzc + GATE_OPENING_HALF
        d_top = torch.sqrt(da * da + perp * perp + dt_ * dt_) - hb
        d_bot = torch.sqrt(da * da + perp * perp + db_ * db_) - hb
        z_cl = torch.clamp(dzc, -e_half, e_half)
        al = along + GATE_OPENING_HALF
        ar = along - GATE_OPENING_HALF
        dz_ = dzc - z_cl
        d_l = torch.sqrt(al * al + perp * perp + dz_ * dz_) - hb
        d_r = torch.sqrt(ar * ar + perp * perp + dz_ * dz_) - hb
        s_cl = torch.clamp(dzc - GATE_SUPPORT_CENTER_DZ,
                           -GATE_SUPPORT_HALF_LEN, GATE_SUPPORT_HALF_LEN)
        ds_ = dzc - GATE_SUPPORT_CENTER_DZ - s_cl
        d_s = torch.sqrt(relx * relx + rely * rely + ds_ * ds_) \
            - GATE_SUPPORT_RADIUS
        dmin = torch.minimum(
            torch.minimum(torch.minimum(d_top, d_bot),
                          torch.minimum(d_l, d_r)),
            d_s,
        )
        gate_range.append((dmin < VISIBILITY_RANGE).to(f32))
    obst_range = []
    for o in range(O):
        dx, dy = px - ox_a[o], py - oy_a[o]
        dxy = torch.sqrt(dx * dx + dy * dy)
        dz_out = torch.clamp_min(
            torch.maximum(tc["o_lo"][o] - pz, pz - tc["o_hi"][o]), 0.0)
        dmin = torch.sqrt(dxy * dxy + dz_out * dz_out) - OBSTACLE_RADIUS
        obst_range.append((dmin < VISIBILITY_RANGE).to(f32))

    gate_pose_rows = []
    for g in range(G):
        in_r = gate_range[g] > 0.5
        nx, ny, nz, nyaw = tc["g_nom"][g]
        gate_pose_rows.append([
            torch.where(in_r, gx_a[g], float(nx)),
            torch.where(in_r, gy_a[g], float(ny)),
            torch.full_like(px, float(nz)),
            torch.where(in_r, gyaw_a[g], float(nyaw)),
        ])
    obst_pose_rows = []
    for o in range(O):
        in_r = obst_range[o] > 0.5
        nx, ny, nz = tc["o_nom"][o]
        obst_pose_rows.append([
            torch.where(in_r, ox_a[o], float(nx)),
            torch.where(in_r, oy_a[o], float(ny)),
            torch.full_like(px, float(nz)),
        ])

    # ---- 4. termination / shaping --------------------------------------------
    ep_steps = ep_steps0 + 1
    done_mask = (torch.maximum(eliminated, finished)
                 if tc["done_on_completion"] else eliminated)
    all_done = done_mask.reshape(N, Tb, LANE).amin(dim=0)
    terminated = all_done > 0.5
    if tc["end_after_gate"]:
        terminated = terminated | (_d(current_gate, 0) >= tc["end_after_gate"])
    truncated = (ep_steps * float(n_ticks)) * tc["inv_freq"] \
        > tc["episode_len_sec"]
    task_completed = finished.reshape(N, Tb, LANE).amin(dim=0) > 0.5

    shape_gate_id = Rb[3]
    sg_mod = shape_gate_id - float(G) * torch.floor(
        shape_gate_id * tc["inv_G"])
    passed = current_gate > sg_mod
    gid = torch.clamp(current_gate, 0.0, G - 1.0)
    tx = torch.zeros_like(px)
    ty = torch.zeros_like(px)
    tz = torch.zeros_like(px)
    for g in range(G):
        m = (gid == g).to(f32)
        tx = tx + m * gate_pose_rows[g][0]
        ty = ty + m * gate_pose_rows[g][1]
        tz = tz + m * gate_pose_rows[g][2]
    new_tx = torch.where(passed, tx, Rb[4])
    new_ty = torch.where(passed, ty, Rb[5])
    new_tz = torch.where(passed, tz, Rb[6])
    new_gate_id = torch.where(passed, current_gate, shape_gate_id)
    r_passed = torch.where(passed, 5.0, 0.0)
    prev_px, prev_py, prev_pz = Rb[7], Rb[8], Rb[9]
    ex, ey = new_tx - prev_px, new_ty - prev_py
    d_prev_xy = torch.sqrt(ex * ex + ey * ey)
    cx, cy = new_tx - px, new_ty - py
    d_cur_xy = torch.sqrt(cx * cx + cy * cy)
    d_prev_z = torch.abs(new_tz - prev_pz)
    d_cur_z = torch.abs(new_tz - pz)
    progress = (d_prev_xy - d_cur_xy) + (d_prev_z - d_cur_z) + r_passed

    if tc["per_drone_reward"]:
        elim_edge = eliminated - Rb[1]
        finish_edge = finished - Rb[2]
        reward = progress - elim_penalty * elim_edge + 10.0 * finish_edge
    else:
        r_coll = torch.where(terminated & ~task_completed, -1.0, 0.0)
        r_lap = torch.where(terminated & task_completed, 10.0, 0.0)
        reward = _env_rows(_d(progress, 0) + r_coll + r_lap)

    # ---- 5. observation channels ---------------------------------------------
    obs_list = (
        [px, py, pz, roll, pitch, yaw, vx, vy, vz, ox_w, oy_w, oz_w]
        + [ch for g in range(G) for ch in gate_pose_rows[g]]
        + gate_range
        + [ch for o in range(O) for ch in obst_pose_rows[o]]
        + obst_range
        + [current_gate]
    )

    def opponents(rows_of):
        """COMPETE opponent channels: for each opponent slot j, pose rows
        of the j-th other drone (ascending index, skipping self)."""
        out = []
        for j in range(N - 1):
            for ch in rows_of:
                blocks = []
                for d in range(N):
                    e = [e_ for e_ in range(N) if e_ != d][j]
                    blocks.append(_d(ch, e))
                out.append(torch.cat(blocks, dim=0))
        return out

    if compete:
        obs_list += opponents((px, py, pz, roll, pitch, yaw))
    obs_rows = torch.stack(obs_list, dim=0)

    # ---- 6. autoreset ---------------------------------------------------------
    done = terminated | truncated                  # (Tb, 128)
    d_env = done.to(f32)
    d_rows = _env_rows(d_env)
    done_rows = d_rows > 0.5                       # (T, 128)

    rpx, rpy_, rpz = rst[0], rst[1], rst[2]
    rroll, rpitch, ryaw = rst[3], rst[4], rst[5]
    cr, sr = torch.cos(rroll / 2), torch.sin(rroll / 2)
    cp, sp_ = torch.cos(rpitch / 2), torch.sin(rpitch / 2)
    cy, sy = torch.cos(ryaw / 2), torch.sin(ryaw / 2)
    rqx = sr * cp * cy - cr * sp_ * sy
    rqy = cr * sp_ * cy + sr * cp * sy
    rqz = cr * cp * sy - sr * sp_ * cy
    rqw = cr * cp * cy + sr * sp_ * sy
    zr = torch.zeros_like(px)
    S_reset = torch.stack(
        [rpx, rpy_, rpz, rqx, rqy, rqz, rqw] + [zr] * 14
        + [rroll, rpitch, ryaw] + [zr] * 34,
        dim=0,
    )
    S = torch.where(done_rows[None], S_reset, S)
    gg_new = torch.where(done[None], gates_reset, gg)
    oo_new = torch.where(done[None], obst_reset, oo)
    ep_new = ep_steps * (1 - d_env)

    tgt0x = _env_rows(gates_reset[0])
    tgt0y = _env_rows(gates_reset[1])
    tgt0z = torch.full_like(px, float(tc["g_nom"][0][2]))
    keep = 1 - d_rows
    r_new = torch.stack(
        [
            current_gate * keep,
            eliminated * keep,
            finished * keep,
            new_gate_id * keep,
            torch.where(done_rows, tgt0x, new_tx),
            torch.where(done_rows, tgt0y, new_ty),
            torch.where(done_rows, tgt0z, new_tz),
            torch.where(done_rows, rpx, px),
            torch.where(done_rows, rpy_, py),
            torch.where(done_rows, rpz, pz),
            torch.where(done_rows, rst[6], Rb[10]),
            torch.where(done_rows, rst[7], Rb[11]),
            torch.where(done_rows, rst[8], Rb[12]),
            torch.where(done_rows, rst[9], Rb[13]),
        ],
        dim=0,
    )

    # post-done obs = the fresh episode's first obs
    reset_kin = (rpx, rpy_, rpz, rroll, rpitch, ryaw)
    fresh = {i: v for i, v in enumerate(reset_kin)}
    for g in range(G):
        for k, v in enumerate(tc["g_nom"][g]):
            fresh[12 + 4 * g + k] = float(v)
    for o in range(O):
        for k, v in enumerate(tc["o_nom"][o]):
            fresh[12 + 5 * G + 3 * o + k] = float(v)
    if compete:
        base = 12 + 5 * G + 4 * O + 1
        for i, v in enumerate(opponents(reset_kin)):
            fresh[base + i] = v
    C = obs_rows.shape[0]
    obs_rows = torch.stack(
        [torch.where(done_rows, fresh.get(i, 0.0), obs_rows[i])
         for i in range(C)],
        dim=0,
    )

    out = {
        "S": S, "R": r_new, "GG": gg_new, "OO": oo_new, "EP": ep_new,
        "OBS": obs_rows, "REW": reward, "DONE": d_env,
    }
    if telemetry:
        out["INFO"] = torch.stack(
            [current_gate, eliminated, finished, _env_rows(ep_steps),
             _env_rows(terminated.to(f32))],
            dim=0,
        )
    return out
