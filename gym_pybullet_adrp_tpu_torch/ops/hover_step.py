"""The hover kernels: one control step (K1) and a whole rollout (K2).

Counterpart of gym_pybullet_adrp_tpu/ops/pallas_step.py (``LANE``,
``N_CHANNELS``, ``pack_state``/``unpack_state`` :126-137, ``supports``
:140, ``ctrl_step_packed`` :151, ``ctrl_step`` :185, ``hover_rollout``
:369, ``rollout_step_math`` :434). Scope, as there: one CF2X per env,
``Physics.PYB`` (thrust, body torques, gravity, analytic ground
contact), float32.

Layout: the JAX package's channel-major ``(13, T, 128)`` block, rows
[pos xyz, quat xyzw, vel xyz, omega(body) xyz], so the tests compare like
with like. The kernels (csrc/hover_step.cu, csrc/hover_rollout.cu) run
an env on one thread (K1) or on a group of L lanes (K2, ``lane_count``)
and index the block as ``channel * B + env``.

* ``ctrl_step_packed`` (K1): rpm constant over ``n_substeps`` PYB
  substeps with the exact axis-angle quaternion update.
* ``hover_rollout`` (K2): ``n_steps`` x (uniform action -> rpm -> 8
  substeps -> HoverAviary reward, tilt/bounds/timeout done, per-channel
  autoreset) with the state kept by its thread; returns the final state
  and each env's summed reward. Its action comes from Philox4x32-10
  (counter (step, env), key ``seed``) or, in the injected mode, from an
  ``actions`` block. The TPU kernel's hardware PRNG has no counterpart
  here, so the random streams of the two packages differ; the injected
  mode is what compares them.

Each kernel has its plain PyTorch version here, which the wrapper takes
for CPU tensors. Every constant is folded on the host in double precision
exactly as the JAX code folds its Python floats before they meet a
float32 row, and the kernels are built with ``-fmad=false``, so kernel
and plain version round every operation alike.

Folding reads the params back from their device, a copy that waits for
the card. A loop of launches folds them once with ``hover_consts`` and
passes the result as ``consts`` (``fast_hover.make_step`` does); the
other settings are then read from it. The folded constants carry their
ctypes struct, so a launch neither reads the params nor fills a struct.
"""

import ctypes
import struct

import numpy as np
import torch

from ._build import (
    call_on as _call, device_index as _index, entry as _entry,
    HOVER_EAGER, launch_error, raw_stream as _stream, refuse_grad,
    sm_count as _sm_count,
)
from .race_window import _check_block
from ..utils.enums import DroneModel, Physics

LANE = 128
N_CHANNELS = 13
ACT_CHANNELS = 4
# threads per block. 32-, 64- and 128-thread blocks gave K2 at one lane
# per env the same device time on an H100 (PERF.md, section 6)
THREADS = 128
# lane counts the rollout kernel is built for (csrc/hover_rollout.cu)
ROLLOUT_LANES = (1, 4)
# the C entry points' arguments, packed into one buffer: ``struct
# RolloutArgs`` of csrc/hover_rollout.cu (st, actions, out, acc, resets,
# consts, stream; B; n_steps, seed, smallangle, near_sqrt, lanes,
# threads) and ``struct StepArgs`` of csrc/hover_step.cu (st, rpm, out,
# consts, stream; B; threads). A ctypes call then converts one pointer,
# not 14 or 7 values.
_ROLLOUT_ARGS = struct.Struct("=7QqiIiiii")
_STEP_ARGS = struct.Struct("=5Qqi4x")

# tilt limits of the trig-free truncation test (pallas_step.py:331-332)
TAN04 = 0.4227932
SIN04 = 0.3894183


# ---------------------------------------------------------------------------
# constants shared bit for bit by the plain versions and the kernels


class HoverConsts(ctypes.Structure):
    """Host-folded constants; mirrors ``struct HoverConsts`` in
    csrc/hover_step.cuh field for field."""

    _fields_ = [
        ("n_substeps", ctypes.c_int),
        ("max_ep_steps", ctypes.c_int),
    ] + [(name, ctypes.c_float) for name in (
        "dt", "kf", "km", "arm_s", "inv_m_dt", "g_dt", "cwx", "cwy", "cwz",
        "hdt", "hdt2", "ground_z", "hover_rpm", "act_mul", "tx", "ty", "tz",
        "init_z", "ps1", "ps2", "pc1", "pc2", "pc3", "tan04", "sin04",
    )]


def hover_consts(params, n_substeps=8, dt=1.0 / 240.0, act_scale=0.05,
                 target=(0.0, 0.0, 1.0), max_ep_steps=240, init_z=0.1125):
    """The Python-float constants of the hover kernels, computed from the
    float32 params as pallas_step.py computes them (:158-167, :396-406)
    and folded as its kernels fold them. Reads every leaf back to the
    host: fold once per loop, not per launch. Returns a read-only dict
    that carries its ctypes struct (``FoldedConsts``)."""
    def f32(x):
        return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                          dtype=np.float32)

    kf = float(f32(params.kf))
    km = float(f32(params.km))
    arm_s = float(f32(params.arm)) / float(np.sqrt(2.0))
    mass = float(f32(params.mass))
    jinv = tuple(float(x) for x in 1.0 / f32(params.J))
    gravity = 9.8 * mass
    ground_z = float(f32(params.collision_h) / 2.0
                     - f32(params.collision_z_offset))
    dt = float(dt)
    half_dt = dt * 0.5
    return FoldedConsts(dict(
        n_substeps=int(n_substeps), max_ep_steps=int(max_ep_steps),
        dt=dt, kf=kf, km=km, arm_s=arm_s,
        inv_m_dt=dt / mass, g_dt=dt * gravity / mass,
        cwx=dt * jinv[0], cwy=dt * jinv[1], cwz=dt * jinv[2],
        hdt=half_dt, hdt2=half_dt * half_dt, ground_z=ground_z,
        hover_rpm=float(np.sqrt(gravity / (4.0 * kf))),
        act_scale=float(act_scale), act_mul=2.0 * act_scale,
        tx=float(target[0]), ty=float(target[1]), tz=float(target[2]),
        init_z=float(init_z),
        ps1=-1.0 / 6.0, ps2=1.0 / 120.0,
        pc1=-0.5, pc2=1.0 / 24.0, pc3=-1.0 / 720.0,
        tan04=TAN04, sin04=SIN04,
    ))


class FoldedConsts(dict):
    """``hover_consts``' dict of constants with its ctypes struct
    (``struct``), filled once from the same values. Read-only, so the two
    cannot part."""

    def __init__(self, values):
        super().__init__(values)
        self.struct = _fill_struct(self)

    def _read_only(self, *args, **kwargs):
        raise TypeError("folded hover constants are read-only")

    __setitem__ = __delitem__ = update = pop = popitem = clear = \
        setdefault = _read_only


def _fill_struct(c) -> HoverConsts:
    out = HoverConsts()
    for name, _ in HoverConsts._fields_:
        setattr(out, name, c[name])
    return out


def consts_struct(c) -> HoverConsts:
    """The ctypes struct of the constants ``c``: the one folded with them
    by ``hover_consts``, or a new one for any other dict."""
    return c.struct if isinstance(c, FoldedConsts) else _fill_struct(c)


def lane_count(B: int, n_sm: int = 132) -> int:
    """Lanes per env, L, for a rollout of ``B`` envs on a card of ``n_sm``
    SMs (four sub-partitions, one warp scheduler each). One warp that has
    its sub-partition to itself waits on its envs' dependent chains, and
    the substep cannot be dealt out over lanes (csrc/hover_step.cuh): the
    L ranks of a group repeat it, share the per-step motor terms, and put
    L times the warps on the card. Rule: L = 4 while B * 4 / 32 warps fit
    one per sub-partition, else L = 1, as a second warp per sub-partition
    costs more than it hides. On an H100 (132 SMs): 4 up to 4224 envs,
    then 1. Measured there at 64 steps, small-angle (PERF.md, section
    6): 1024 to 4096 envs L = 4 0.0490 ms, L = 1 0.0571; 8192 L = 1
    0.0571, L = 2 0.0643, L = 4 0.0809; 16384 and 65536 L = 1 fastest.
    (L = 2 never won; L = 8 won 3% at 2048 envs or fewer, a batch no
    path of the port runs, and is not built.)"""
    return 4 if (B // 32) * 4 <= 4 * n_sm else 1


# ---------------------------------------------------------------------------
# layout


def pack_state(pos, quat, vel, omega):
    """(B, 3/4) tensors -> (13, B/128, 128) channel-major block."""
    B = pos.shape[0]
    st = torch.cat([pos, quat, vel, omega], dim=-1)
    return st.T.reshape(N_CHANNELS, B // LANE, LANE).contiguous()


def unpack_state(st):
    """(13, B/128, 128) -> (pos, quat, vel, omega), each (B, 3/4)."""
    B = st.shape[1] * LANE
    flat = st.reshape(N_CHANNELS, B).T
    return flat[:, 0:3], flat[:, 3:7], flat[:, 7:10], flat[:, 10:13]


def supports(params, model, physics, B, dtype) -> bool:
    """Whether the hover kernels cover this configuration."""
    return (physics == Physics.PYB and model == DroneModel.CF2X
            and B % LANE == 0 and dtype == torch.float32)


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _motor(c, rpm):
    """Thrust and the per-substep angular-rate increments of rpm (4, ...)
    (pallas_step.py:40-49)."""
    f = rpm * rpm * c["kf"]
    thrust = f[0] + f[1] + f[2] + f[3]
    tx = (f[0] + f[1] - f[2] - f[3]) * c["arm_s"]
    ty = (-f[0] + f[1] + f[2] - f[3]) * c["arm_s"]
    t_ = rpm * rpm * c["km"]
    tz = t_[0] - t_[1] + t_[2] - t_[3]
    return thrust, c["cwx"] * tx, c["cwy"] * ty, c["cwz"] * tz


def substep_plain(c, ch, thrust, dwx, dwy, dwz, smallangle):
    """One PYB substep of the 13 channels (a list of tensors), with the
    exact (sqrt, sin, cos, div) or the small-angle quaternion update
    (pallas_step.py:52-119, :225-293)."""
    px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz = ch
    fx = 2.0 * (qx * qz + qy * qw) * thrust
    fy = 2.0 * (qy * qz - qx * qw) * thrust
    fz = (1.0 - 2.0 * (qx * qx + qy * qy)) * thrust
    vx = vx + fx * c["inv_m_dt"]
    vy = vy + fy * c["inv_m_dt"]
    vz = vz + fz * c["inv_m_dt"] - c["g_dt"]
    wx = wx + dwx
    wy = wy + dwy
    wz = wz + dwz
    px = px + c["dt"] * vx
    py = py + c["dt"] * vy
    pz = pz + c["dt"] * vz
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
    if smallangle:
        t2 = (ox * ox + oy * oy + oz * oz) * c["hdt2"]
        s_n = c["hdt"] * (1.0 + t2 * (c["ps1"] + t2 * c["ps2"]))
        cc = 1.0 + t2 * (c["pc1"] + t2 * (c["pc2"] + t2 * c["pc3"]))
        ux, uy, uz = ox * s_n, oy * s_n, oz * s_n
        qx, qy, qz, qw = (
            cc * qx + qw * ux + (uy * qz - uz * qy),
            cc * qy + qw * uy + (uz * qx - ux * qz),
            cc * qz + qw * uz + (ux * qy - uy * qx),
            cc * qw - (ux * qx + uy * qy + uz * qz),
        )
    else:
        n = torch.sqrt(ox * ox + oy * oy + oz * oz)
        safe = torch.clamp_min(n, 1e-12)
        theta = n * c["hdt"]
        s_n = torch.sin(theta) / safe
        cc = torch.cos(theta)
        ux, uy, uz = ox * s_n, oy * s_n, oz * s_n
        nqx = cc * qx + qw * ux + (uy * qz - uz * qy)
        nqy = cc * qy + qw * uy + (uz * qx - ux * qz)
        nqz = cc * qz + qw * uz + (ux * qy - uy * qx)
        nqw = cc * qw - (ux * qx + uy * qy + uz * qz)
        keep = n <= 1e-8
        qx = torch.where(keep, qx, nqx)
        qy = torch.where(keep, qy, nqy)
        qz = torch.where(keep, qz, nqz)
        qw = torch.where(keep, qw, nqw)
    below = pz < c["ground_z"]
    pz = torch.where(below, c["ground_z"], pz)
    vx = torch.where(below, 0.0, vx)
    vy = torch.where(below, 0.0, vy)
    vz = torch.where(below, torch.clamp_min(vz, 0.0), vz)
    wx = torch.where(below, 0.0, wx)
    wy = torch.where(below, 0.0, wy)
    wz = torch.where(below, 0.0, wz)
    return [px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz]


def ctrl_step_packed_plain(params, packed_state, rpm_packed, n_substeps: int,
                           dt: float, consts=None):
    """Plain PyTorch version of ``ctrl_step_packed`` (any device)."""
    c = consts or hover_consts(params, n_substeps, dt)
    thrust, dwx, dwy, dwz = _motor(c, rpm_packed)
    ch = list(packed_state)
    for _ in range(c["n_substeps"]):
        ch = substep_plain(c, ch, thrust, dwx, dwy, dwz, smallangle=False)
    return torch.stack(ch, dim=0)


# Philox4x32-10 (Salmon et al., SC'11; the generator of cuRAND's
# curand_Philox4x32_10), written with int64 tensors: every value is a
# uint32 in [0, 2^32)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(m, x):
    """(hi, lo) 32-bit halves of the 64-bit product m * x."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    lo = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (lo >> 32), lo & _U32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """The four 32-bit outputs of Philox4x32-10 for counters ``c0..c3``
    (int64 tensors of uint32 values) and key ``(k0, k1)`` (ints)."""
    for r in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _U32
        k1 = (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def uniform_actions(seed, step, shape, act_scale, device):
    """The kernel's action draw for one step: (4, *shape) float32 in
    [-act_scale, act_scale), from Philox4x32-10 with counter (step, env,
    0, 0) and key (seed, 0), each 32-bit output mapped to [1, 2) by
    ``(bits >> 9) | 0x3F800000`` as the TPU kernel maps its bits
    (pallas_step.py:295-302)."""
    n = int(np.prod(shape))
    env = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(env)
    outs = philox4x32(torch.full_like(env, step & _U32), env & _U32,
                      env >> 32, zero, int(seed) & _U32, 0)
    bits = torch.stack(outs).reshape((4,) + tuple(shape))
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (u - 1.5) * (2.0 * act_scale)


def rollout_step_plain(c, ch, a, steps, acc, smallangle, near_sqrt):
    """One step of the rollout kernel: rpm from the action ``a`` (4, ...),
    the substeps, the HoverAviary reward, done and autoreset
    (pallas_step.py:304-358). Returns (ch, steps, acc, reward, done)."""
    rpm = c["hover_rpm"] * (1.0 + 0.05 * a)
    thrust, dwx, dwy, dwz = _motor(c, rpm)
    for _ in range(c["n_substeps"]):
        ch = substep_plain(c, ch, thrust, dwx, dwy, dwz, smallangle)
    px, py, pz = ch[0], ch[1], ch[2]
    qx, qy, qz, qw = ch[3], ch[4], ch[5], ch[6]
    ex, ey, ez = px - c["tx"], py - c["ty"], pz - c["tz"]
    e2 = ex * ex + ey * ey + ez * ez
    reward = torch.clamp_min(2.0 - e2 * e2, 0.0)
    sinr = 2.0 * (qw * qx + qy * qz)
    cosr = 1.0 - 2.0 * (qx * qx + qy * qy)
    roll_out = (cosr <= 0.0) | (torch.abs(sinr) > c["tan04"] * cosr)
    sinp = 2.0 * (qw * qy - qz * qx)
    pitch_out = torch.abs(sinp) > c["sin04"]
    steps = steps + 1
    near = (torch.sqrt(e2) < 1e-4) if near_sqrt else (e2 < 1e-8)
    done = (near | (torch.abs(px) > 1.5) | (torch.abs(py) > 1.5)
            | (pz > 2.0) | roll_out | pitch_out | (steps > c["max_ep_steps"]))
    ch = [torch.where(done, c["init_z"] if i == 2 else
                      1.0 if i == 6 else 0.0, x) for i, x in enumerate(ch)]
    steps = torch.where(done, 0, steps)
    return ch, steps, acc + reward, reward, done


def rollout_plain(c, packed_state, seed, n_steps, smallangle, near_sqrt,
                  actions, count_resets):
    """The rollout kernel's ``<smallangle, near_sqrt>`` instantiation in
    plain PyTorch, from folded constants ``c``: the plain version of K2
    here and of K7/K8 in hover_variants.py."""
    shape = packed_state.shape[1:]
    dev = packed_state.device
    ch = list(packed_state)
    steps = torch.zeros(shape, dtype=torch.int32, device=dev)
    acc = torch.zeros(shape, dtype=torch.float32, device=dev)
    resets = torch.zeros(shape, dtype=torch.float32, device=dev)
    for k in range(n_steps):
        a = (actions[k] if actions is not None
             else uniform_actions(seed, k, shape, c["act_scale"], dev))
        ch, steps, acc, _, done = rollout_step_plain(
            c, ch, a, steps, acc, smallangle, near_sqrt)
        resets = resets + done.to(torch.float32)
    out = (torch.stack(ch, dim=0), acc)
    return out + (resets,) if count_resets else out


def hover_rollout_plain(params, packed_state, seed, n_steps: int,
                        n_substeps: int = 8, dt: float = 1.0 / 240.0,
                        act_scale: float = 0.05, target=(0.0, 0.0, 1.0),
                        max_ep_steps: int = 240, init_z: float = 0.1125,
                        smallangle: bool = True, actions=None,
                        count_resets=False, consts=None):
    """Plain PyTorch version of ``hover_rollout`` (any device), the same
    Philox draws included."""
    c = consts or hover_consts(params, n_substeps, dt, act_scale, target,
                               max_ep_steps, init_z)
    return rollout_plain(c, packed_state, seed, n_steps, smallangle,
                         not smallangle, actions, count_resets)


def rollout_step_math(params, packed, action, steps, acc,
                      n_substeps: int = 8, dt: float = 1.0 / 240.0,
                      target=(0.0, 0.0, 1.0), max_ep_steps: int = 240,
                      init_z: float = 0.1125, smallangle: bool = True):
    """ONE step of the rollout kernel's math with the action injected
    (the twin of pallas_step.rollout_step_math :434). packed (13, T, 128);
    action (4, T, 128); steps (T, 128) int32; acc (T, 128). Returns
    (packed, steps, acc, reward)."""
    c = hover_consts(params, n_substeps, dt, 0.05, target, max_ep_steps,
                     init_z)
    ch, steps, acc, reward, _ = rollout_step_plain(
        c, list(packed), action, steps, acc, smallangle, not smallangle)
    return torch.stack(ch, dim=0), steps, acc, reward


# ---------------------------------------------------------------------------
# the kernels' wrappers


def _check_state(name, packed_state):
    """T of a contiguous float32 (13, T, 128) state; raises otherwise."""
    if not isinstance(packed_state, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got "
                        f"{type(packed_state)}")
    shape = packed_state.shape
    if len(shape) != 3 or shape[0] != N_CHANNELS or shape[2] != LANE:
        raise ValueError(f"{name}: expected a (13, T, 128) state, got "
                         f"{tuple(shape)}")
    if packed_state.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got "
                        f"{packed_state.dtype}")
    if not packed_state.is_contiguous():
        raise ValueError(f"{name}: the state must be contiguous")
    return shape[1]


def ctrl_step_packed(params, packed_state, rpm_packed, n_substeps: int,
                     dt: float, consts=None):
    """One fused control step on the packed state: (13, T, 128) state and
    (4, T, 128) rpm -> the new (13, T, 128) state. ``consts``, when
    given, is ``hover_consts(params, n_substeps, dt)``, folded once.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (csrc/hover_step.cu) on the current stream, counting the launch in
    ``ctrl_step_packed.launches``. Any other device raises, and so does
    a call that autograd would record (the kernel has no backward)."""
    refuse_grad("ctrl_step_packed", "ops/dynamics.ctrl_step", packed_state,
                rpm_packed)
    dev = packed_state.device
    if dev.type == "cpu":
        return ctrl_step_packed_plain(params, packed_state, rpm_packed,
                                      n_substeps, dt, consts)
    if dev.type != "cuda":
        raise ValueError(f"ctrl_step_packed: unsupported device {dev}")
    T = _check_state("ctrl_step_packed", packed_state)
    _check_block("rpm_packed", rpm_packed, (ACT_CHANNELS, T, LANE), dev)
    out = torch.empty_like(packed_state)
    cs = consts_struct(consts or hover_consts(params, n_substeps, dt))
    idx = _index(dev)
    err = _call(idx, _entry("hover_step"), _STEP_ARGS.pack(
        packed_state.data_ptr(), rpm_packed.data_ptr(), out.data_ptr(),
        ctypes.addressof(cs), _stream(idx), T * LANE, THREADS))
    launch_error("ctrl_step_packed", err)
    ctrl_step_packed.launches += 1
    return out


ctrl_step_packed.launches = 0


def ctrl_step(params, pos, quat, vel, omega, rpm, n_substeps: int,
              dt: float):
    """Standard-layout wrapper: (B, .) state tensors and (B, 4) rpm in,
    (pos, quat, vel, omega) out."""
    B = pos.shape[0]
    packed = pack_state(pos, quat, vel, omega)
    rpm_packed = rpm.T.reshape(ACT_CHANNELS, B // LANE, LANE).contiguous()
    return unpack_state(ctrl_step_packed(params, packed, rpm_packed,
                                         n_substeps, dt))


def launch_rollout(name, c, packed_state, seed, n_steps, smallangle,
                   near_sqrt, actions, count_resets):
    """Launch the rollout kernel's ``<smallangle, near_sqrt>``
    instantiation (csrc/hover_rollout.cu: ``<true, false>``, ``<false,
    true>`` or ``<false, false>``) for a CUDA state and folded constants
    ``c``; returns
    (state, acc[, resets]). The caller counts the launch."""
    dev = packed_state.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    T = _check_state(name, packed_state)
    if actions is not None:
        _check_block("actions", actions, (n_steps, ACT_CHANNELS, T, LANE),
                     dev)
    if n_steps < 0:
        raise ValueError(f"{name}: n_steps {n_steps} < 0")
    out = torch.empty_like(packed_state)
    acc = packed_state.new_empty((T, LANE))
    resets = packed_state.new_empty((T, LANE)) if count_resets else None
    cs = consts_struct(c)
    B, idx = T * LANE, _index(dev)
    err = _call(idx, _entry("hover_rollout"), _ROLLOUT_ARGS.pack(
        packed_state.data_ptr(), 0 if actions is None else actions.data_ptr(),
        out.data_ptr(), acc.data_ptr(),
        0 if resets is None else resets.data_ptr(), ctypes.addressof(cs),
        _stream(idx), B, int(n_steps), int(seed) & 0xFFFFFFFF,
        int(bool(smallangle)), int(bool(near_sqrt)),
        lane_count(B, _sm_count(idx)), THREADS))
    launch_error(name, err)
    return (out, acc, resets) if count_resets else (out, acc)


def hover_rollout(params, packed_state, seed, n_steps: int,
                  n_substeps: int = 8, dt: float = 1.0 / 240.0,
                  act_scale: float = 0.05, target=(0.0, 0.0, 1.0),
                  max_ep_steps: int = 240, init_z: float = 0.1125,
                  smallangle: bool = True, actions=None,
                  count_resets: bool = False, consts=None):
    """``n_steps`` control steps of random RPM actions, physics and the
    Hover reward and episode logic in one launch. Returns (final packed
    state, per-env summed reward (T, 128)), and with ``count_resets`` the
    number of episode ends per env (T, 128).

    ``smallangle`` (default) integrates the quaternion with Horner
    polynomials in theta^2 and tests ``|e| < 1e-4`` as ``e^2 < 1e-8``;
    False runs the exact (sqrt, sin, cos, div) integrator and
    ``sqrt(e^2) < 1e-4``, as the JAX kernel does. ``actions`` (n_steps,
    4, T, 128) float32 in [-act_scale, act_scale) replaces the in-kernel
    Philox draw (``seed`` is then not read). ``consts``, when given, is
    ``hover_consts`` of the params and settings, folded once.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (csrc/hover_rollout.cu), counting the launch in
    ``hover_rollout.launches``. Any other device raises, and so does a
    call that autograd would record (the kernel has no backward)."""
    refuse_grad("hover_rollout", HOVER_EAGER, packed_state, actions)
    c = consts or hover_consts(params, n_substeps, dt, act_scale, target,
                               max_ep_steps, init_z)
    if packed_state.device.type == "cpu":
        return rollout_plain(c, packed_state, seed, n_steps, smallangle,
                             not smallangle, actions, count_resets)
    out = launch_rollout("hover_rollout", c, packed_state, seed, n_steps,
                         smallangle, not smallangle, actions, count_resets)
    hover_rollout.launches += 1
    return out


hover_rollout.launches = 0
