"""The race firmware window (K3): plain PyTorch version + CUDA kernel wrapper.

Counterpart of gym_pybullet_adrp_tpu/ops/pallas_race.py (``race_window``
:664, body ``_window_loop`` :178). One call runs a control step's 20-tick
500 Hz firmware window for every agent: PYB rigid-body physics with
per-agent mass/inertia and optional injected wind/thrust noise, the
commander's poly7 setpoint, the Mellinger sensor biquads, tick gating and
tumble cutoff, the control law, and power distribution + motor pipeline.

Blocks are channel-major float32 ``(C, T, 128)`` with the JAX package's
channel maps:

S (58, T, 128):
  0:3   pos        3:7  quat xyzw   7:10 vel      10:13 omega(body)
  13:17 rpms       17:21 prev_rpms
  21:24 prev_rpy   24:27 prev_vel
  27:30 acc_lpf_d1 30:33 acc_lpf_d2  33:36 gyro_lpf_d1 36:39 gyro_lpf_d2
  39:42 i_err_pos  42:45 i_err_m     45:47 prev_omega_rp
  47:49 prev_sp_omega_rp             49:53 control_rpyt
  53 tick  54 last_pos_call  55 last_att_call  56 tumble_counter
  57 error_flag

W (57, T, 128):
  0:3 sp_pos  3:6 sp_vel  6:9 sp_acc  9:12 sp_att_rate(deg/s)
  12 sp_yaw_quat_deg  13 sp_thrust  14 pos_mode(1=modeAbs on x)
  15 z_mode_disable   16 planner_mode(1=poly setpoint per tick)
  17 t_begin  18 duration  19 eliminated
  20:52 poly coeffs (x8,y8,z8,yaw8; normalized time)
  52 mass  53:56 J diag  56 (reserved)

noise_rows (n_ticks, 7, T, 128): per tick, additive wind force xyz and
per-motor thrust noise. The TPU kernel can draw these with its in-kernel
PRNG; the port always takes them as an input, drawn by the caller with a
``torch.Generator`` (the JAX package's interpret-mode route).

``window_loop_plain`` transcribes ``_window_loop`` op for op, including
the cephes ``atan``/``atan2``/``asin`` polynomials, and the CUDA kernel
(csrc/race_window.cuh) transcribes the plain version, so on the card the
two agree to rounding: the kernel is built with ``-fmad=false``, as
PyTorch's eager ops round every multiply and add separately. A division
by a constant is a multiplication by the float32 reciprocal of the
float32 constant, on both sides: that is what XLA folds ``x / c`` into,
so the tick-gating comparisons (``cur_time - last > 0.002``) fall on the
same side as in the JAX package.
"""

import ctypes
import math

import numpy as np
import torch

from ..control import mellinger as mel
from . import _build

LANE = 128
S_CHANNELS = 58
W_CHANNELS = 57
NOISE_CHANNELS = 7

RAD2DEG = 180.0 / math.pi
DEG2RAD = math.pi / 180.0

_PI = math.pi


# ---------------------------------------------------------------------------
# constants shared bit for bit by the plain version and the kernel


class WindowConsts(ctypes.Structure):
    """Host-folded window constants; mirrors ``struct WindowConsts`` in
    csrc/race_window.cuh field for field. Each value is the Python float
    the JAX kernel folds before it meets a float32 row, so both sides
    round it to float32 the same way."""

    _fields_ = [
        ("n_ticks", ctypes.c_int),
        ("dt", ctypes.c_float),
        ("kf", ctypes.c_float),
        ("km", ctypes.c_float),
        ("arm_s", ctypes.c_float),
        ("inv_dt", ctypes.c_float),
        ("inv_dt_g", ctypes.c_float),
        ("ground_z", ctypes.c_float),
        ("qdt2", ctypes.c_float),
        ("hdt", ctypes.c_float),
        ("inv_kf", ctypes.c_float),
        ("tick_recip", ctypes.c_float),
        ("acc", ctypes.c_float * 5),
        ("gyro", ctypes.c_float * 5),
    ]


def window_consts(kf, km, arm, ground_z, dt, n_ticks):
    """Python-float constants of the window (see ``WindowConsts``)."""
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


def window_consts_struct(c) -> WindowConsts:
    out = WindowConsts()
    for name, val in c.items():
        if isinstance(val, tuple):
            getattr(out, name)[:] = val
        else:
            setattr(out, name, val)
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version


def recip32(c) -> float:
    """The float32 reciprocal of the float32 constant ``c``, as a Python
    float: ``x * recip32(c)`` is how XLA evaluates ``x / c``."""
    return float(np.float32(1.0) / np.float32(c))


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


def unpack_window(W):
    """W block -> the window-static dict ``window_loop_plain`` reads."""
    return dict(
        sp_pos=(W[0], W[1], W[2]),
        sp_vel=(W[3], W[4], W[5]),
        sp_acc=(W[6], W[7], W[8]),
        sp_rate=(W[9], W[10], W[11]),
        sp_yaw_quat_deg=W[12],
        sp_thrust=W[13],
        pos_mode=W[14] > 0.5,
        z_disable=W[15] > 0.5,
        planner=W[16] > 0.5,
        t_begin=W[17],
        duration=W[18],
        eliminated=W[19] > 0.5,
        coeffs=W[20:52],
        mass=W[52],
        J=(W[53], W[54], W[55]),
    )


def window_loop_plain(S, wv, c, noise_rows=None):
    """The 20-tick firmware window over (58, T, 128) rows; transcribes
    pallas_race._window_loop. ``wv`` is the window-static dict (see
    ``unpack_window``); ``wv['coeffs'] is None`` takes the fused step's
    branch, which has no poly7 planner and a window-static desired yaw.
    ``c`` is ``window_consts(...)``. Returns the final S block."""
    n_ticks, dt = c["n_ticks"], c["dt"]
    kf, km, arm_s = c["kf"], c["km"], c["arm_s"]
    inv_dt, inv_dt_g, ground_z = c["inv_dt"], c["inv_dt_g"], c["ground_z"]
    acc_b0, acc_b1, acc_b2, acc_a1, acc_a2 = c["acc"]
    gy_b0, gy_b1, gy_b2, gy_a1, gy_a2 = c["gyro"]

    sp_pos, sp_vel = wv["sp_pos"], wv["sp_vel"]
    sp_acc, sp_rate = wv["sp_acc"], wv["sp_rate"]
    sp_yaw_quat_deg, sp_thrust = wv["sp_yaw_quat_deg"], wv["sp_thrust"]
    pos_mode, z_disable = wv["pos_mode"], wv["z_disable"]
    planner, t_begin, duration = wv["planner"], wv["t_begin"], wv["duration"]
    eliminated, coeffs, mass = wv["eliminated"], wv["coeffs"], wv["mass"]
    Jx, Jy, Jz = wv["J"]
    inv_mass = torch.ones_like(mass) / mass
    inv_Jx = torch.ones_like(Jx) / Jx
    inv_Jy = torch.ones_like(Jy) / Jy
    inv_Jz = torch.ones_like(Jz) / Jz
    xc_static = None
    if coeffs is None:
        dy0 = sp_yaw_quat_deg * DEG2RAD
        xc_static = (torch.cos(dy0), torch.sin(dy0))

    def poly_eval(t_rel):
        safe_T = torch.where(duration > 0, duration, 1.0)
        s = torch.clamp(t_rel / safe_T, 0.0, 1.0)
        outs = []
        for ch in range(4):
            cc = [coeffs[8 * ch + i] for i in range(8)]
            pv = cc[7]
            dv = 7.0 * cc[7]
            av = 42.0 * cc[7]
            for i in range(6, -1, -1):
                pv = pv * s + cc[i]
                if i >= 1:
                    dv = dv * s + float(i) * cc[i]
                if i >= 2:
                    av = av * s + float(i * (i - 1)) * cc[i]
            outs.append((pv, dv / safe_T, av / (safe_T * safe_T)))
        return outs

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
        t_now = tick * dt
        if coeffs is None:
            spx, spy, spz = sp_pos
            svx, svy, svz = sp_vel
            sax, say, saz = sp_acc
            srx, sry, srz = sp_rate
            desired_yaw_deg = sp_yaw_quat_deg
        else:
            pe = poly_eval(t_now - t_begin)
            spx = torch.where(planner, pe[0][0], sp_pos[0])
            spy = torch.where(planner, pe[1][0], sp_pos[1])
            spz = torch.where(planner, pe[2][0], sp_pos[2])
            svx = torch.where(planner, pe[0][1], sp_vel[0])
            svy = torch.where(planner, pe[1][1], sp_vel[1])
            svz = torch.where(planner, pe[2][1], sp_vel[2])
            sax = torch.where(planner, pe[0][2], sp_acc[0])
            say = torch.where(planner, pe[1][2], sp_acc[1])
            saz = torch.where(planner, pe[2][2], sp_acc[2])
            srx = torch.where(planner, 0.0, sp_rate[0])
            sry = torch.where(planner, 0.0, sp_rate[1])
            srz = torch.where(planner, pe[3][1] * RAD2DEG, sp_rate[2])
            desired_yaw_deg = torch.where(
                planner, pe[3][0] * RAD2DEG, sp_yaw_quat_deg
            )

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
        if coeffs is None:
            xcx, xcy = xc_static
        else:
            dy_rad = desired_yaw_deg * DEG2RAD
            xcx, xcy = torch.cos(dy_rad), torch.sin(dy_rad)
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


def race_window_plain(kf, km, arm, ground_z, S, W, n_ticks=20,
                      dt=1.0 / 500.0, noise_rows=None):
    """Plain PyTorch version of ``race_window`` (any device)."""
    c = window_consts(kf, km, arm, ground_z, dt, n_ticks)
    return window_loop_plain(S, unpack_window(W), c, noise_rows=noise_rows)


# ---------------------------------------------------------------------------
# the kernel's wrapper


def _check_block(name, x, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def race_window(kf, km, arm, ground_z, S, W, n_ticks: int = 20,
                dt: float = 1.0 / 500.0, noise_rows=None):
    """Run one control step's firmware window; returns the new S block.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (csrc/race_window.cu, one thread per agent) on the current stream,
    counting the launch in ``race_window.launches``. Any other device
    raises."""
    dev = S.device
    if dev.type == "cpu":
        return race_window_plain(kf, km, arm, ground_z, S, W, n_ticks, dt,
                                 noise_rows)
    if dev.type != "cuda":
        raise ValueError(f"race_window: unsupported device {dev}")
    if S.dim() != 3 or S.shape[0] != S_CHANNELS or S.shape[2] != LANE:
        raise ValueError(f"S: expected (58, T, 128), got {tuple(S.shape)}")
    T = S.shape[1]
    _check_block("S", S, (S_CHANNELS, T, LANE), dev)
    _check_block("W", W, (W_CHANNELS, T, LANE), dev)
    if noise_rows is not None:
        _check_block("noise_rows", noise_rows,
                     (n_ticks, NOISE_CHANNELS, T, LANE), dev)
    out = torch.empty_like(S)
    consts = window_consts_struct(
        window_consts(kf, km, arm, ground_z, dt, n_ticks)
    )
    lib = _build.library("race_window")
    with torch.cuda.device(dev):
        err = lib.adrp_race_window(
            S.data_ptr(), W.data_ptr(),
            noise_rows.data_ptr() if noise_rows is not None else None,
            out.data_ptr(), T * LANE, ctypes.addressof(consts),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"race_window kernel launch failed: {_build.error_string(err)}"
        )
    race_window.launches += 1
    return out


race_window.launches = 0
