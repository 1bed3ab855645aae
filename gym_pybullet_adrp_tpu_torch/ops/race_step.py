"""The fused race RL step (K4): plain PyTorch version + CUDA kernel wrapper.

Counterpart of gym_pybullet_adrp_tpu/ops/pallas_race_step.py
(``race_step_fused`` :897, body ``_step_core`` :151). One call runs one
env step: the FULLSTATE action becomes the window statics, the 20-tick
firmware window runs (the same device function as ``race_window``), and
the control-rate tail follows: gate progress, gate/obstacle/ground/drone
collisions, visibility, termination, RewardWrapper shaping, observation
assembly and autoreset from injected draws.

Block channel maps (beyond race_window's S):

R (14, T, 128) race rows:
  0 current_gate  1 eliminated  2 finished  3 shape_gate_id
  4:7 target_xyz  7:10 prev_pos  10 mass  11:14 J diag
GG (3G, Tb, 128) / OO (2O, Tb, 128): per-env actual geometry
  ([gx, gy, gyaw] per gate / [ox, oy] per obstacle)
EP (Tb, 128): episode ctrl-step counter
RST (10, T, 128) reset draws: [px, py, pz, roll, pitch, yaw, mass, J diag]
RSTG (3G, Tb, 128) / RSTO (2O, Tb, 128): reset geometry rows

Outputs: S' (58), R' (14), GG', OO', EP', OBS (C, T, 128), REW (T, 128),
DONE (Tb, 128) and, with ``telemetry``, INFO (5, T, 128): the
pre-autoreset rows [current_gate, eliminated, finished, ep_steps,
terminated]. T = N * Tb with drone d of every env in rows
[d*Tb, (d+1)*Tb).

Policy option (``_policy_forward`` :92): with a policy pack, the previous
obs rows (C, T, 128) and standard-normal draws (4, T, 128), the
ActorCritic forward and Gaussian sample run first and their clipped
action drives the step; three outputs follow the others: the unclipped
ACT (4, T, 128), LOGP (T, 128) and VAL (T, 128). The pack is the port's
own (``policy_layout``): each weight compact, (out, in) row-major
float32, then the biases and log_std. The JAX pack's (rows, 128)
lane-broadcast blocks are a TPU tiling artifact.
"""

import ctypes
import math

import numpy as np
import torch

from ..utils.constants import (
    GATE_BEAM_HALF, GATE_EDGE_HALF_LEN, GATE_OPENING_HALF, GATE_RAY_HALF_LEN,
    GATE_SUPPORT_CENTER_DZ, GATE_SUPPORT_HALF_LEN, GATE_SUPPORT_RADIUS,
    OBSTACLE_HALF_LEN, OBSTACLE_RADIUS, RAD_TO_DEG, VISIBILITY_RANGE,
)
from . import _build
from ._build import RACE_EAGER, launch_error, refuse_grad
from .race_window import (
    LANE, NOISE_CHANNELS, S_CHANNELS, WindowConsts, _check_block, recip32,
    window_consts, window_consts_struct, window_loop_plain,
)

R_CHANNELS = 14
RST_CHANNELS = 10
INFO_CHANNELS = 5
ACT_DIM = 4
# static capacity of the kernel's parameter block (csrc/race_step.cuh)
MAX_DRONES = 8
MAX_GATES = 8
MAX_OBSTACLES = 8
# widest hidden layer the in-kernel policy takes (csrc/policy.cuh)
MAX_HIDDEN = 256
LOG_2PI = math.log(2.0 * math.pi)


def obs_channels(N, G, O, compete):
    return 12 + 5 * G + 4 * O + 1 + (6 * (N - 1) if compete and N > 1 else 0)


# ---------------------------------------------------------------------------
# the policy pack and the plain policy forward


class PolicyLayout(ctypes.Structure):
    """Widths and float offsets of the policy pack; mirrors ``struct
    PolicyLayout`` in csrc/policy.cuh."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "C", "H1", "H2", "w1", "w2", "w3", "v1", "v2", "v3",
        "b1", "b2", "b3", "vb1", "vb2", "vb3", "log_std",
    )]


# (name, out, in) of every tensor in pack order; in == 0 marks a vector
def _pack_entries(C, H1, H2):
    return (("w1", H1, C), ("w2", H2, H1), ("w3", ACT_DIM, H2),
            ("v1", H1, C), ("v2", H2, H1), ("v3", 1, H2),
            ("b1", H1, 0), ("b2", H2, 0), ("b3", ACT_DIM, 0),
            ("vb1", H1, 0), ("vb2", H2, 0), ("vb3", 1, 0),
            ("log_std", ACT_DIM, 0))


def policy_layout(C, hidden=(64, 64)):
    """``(PolicyLayout, pack length)`` for obs size ``C`` and the two
    tower widths ``hidden`` (counterpart of ``pp_layout`` :67)."""
    H1, H2 = (int(h) for h in hidden)
    if min(H1, H2) < 1 or max(H1, H2) > MAX_HIDDEN:
        raise ValueError(
            f"the policy pack takes two hidden layers of 1..{MAX_HIDDEN} "
            f"(got {tuple(hidden)})")
    lay = PolicyLayout(C=int(C), H1=H1, H2=H2)
    off = 0
    for name, out, inn in _pack_entries(int(C), H1, H2):
        setattr(lay, name, off)
        off += out * max(inn, 1)
    return lay, off


def pack_policy(C, hidden, tensors):
    """The flat float32 pack from the tensors in ``_pack_entries`` order:
    weights (out, in), then the biases and log_std."""
    lay, n = policy_layout(C, hidden)
    parts = []
    for (name, out, inn), t in zip(_pack_entries(lay.C, lay.H1, lay.H2),
                                   tensors):
        shape = (out, inn) if inn else (out,)
        if tuple(t.shape) != shape:
            raise ValueError(f"pack entry {name}: shape {tuple(t.shape)}, "
                             f"expected {shape}")
        parts.append(t.detach().reshape(-1).to(torch.float32))
    pack = torch.cat(parts).contiguous()
    assert pack.numel() == n
    return pack


def policy_forward_plain(pack, hidden, obs_rows, actn):
    """Plain version of the in-kernel forward and sample (csrc/policy.cuh,
    ``_policy_forward`` :92). ``obs_rows`` (C, T, 128), ``actn`` (4, T,
    128) standard-normal draws. Returns (ACT unclipped (4, T, 128), LOGP
    (T, 128), VAL (T, 128)). Every dot product accumulates over the inner
    dimension in ascending order from 0 and adds the bias last, as the
    kernel does, so the two agree to the bit on the card."""
    lay, _ = policy_layout(obs_rows.shape[0], hidden)

    def dense(w, b, out, inn, x, act):
        W = pack[w:w + out * inn].reshape(out, inn)
        acc = torch.zeros((out,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        for i in range(inn):
            acc = acc + W[:, i, None, None] * x[i]
        v = acc + pack[b:b + out][:, None, None]
        return torch.tanh(v) if act else v

    C, H1, H2 = lay.C, lay.H1, lay.H2
    h = dense(lay.w1, lay.b1, H1, C, obs_rows, True)
    h = dense(lay.w2, lay.b2, H2, H1, h, True)
    mean = dense(lay.w3, lay.b3, ACT_DIM, H2, h, False)
    v = dense(lay.v1, lay.vb1, H1, C, obs_rows, True)
    v = dense(lay.v2, lay.vb2, H2, H1, v, True)
    val = dense(lay.v3, lay.vb3, 1, H2, v, False)[0]
    log_std = pack[lay.log_std:lay.log_std + ACT_DIM][:, None, None]
    act = mean + torch.exp(log_std) * actn
    contrib = -0.5 * (actn * actn + 2.0 * log_std + LOG_2PI)
    logp = contrib[0] + contrib[1] + contrib[2] + contrib[3]
    return act, logp, val


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
    With ``policy`` = (obs_rows, pack, hidden, actn) the policy forward
    and sample run first, ``A`` is ignored and the outputs gain ACT, LOGP
    and VAL. Returns a dict of output blocks."""
    # ---- 0. the policy forward and sample ----------------------------------
    pol = None
    if policy is not None:
        obs_in, pack, hidden, actn = policy
        pol = policy_forward_plain(pack, hidden, obs_in, actn)
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
        pos_mode=alive, z_disable=~alive, planner=None,
        t_begin=z, duration=z, eliminated=~alive,
        coeffs=None,
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


_OUT_ORDER = ("S", "R", "GG", "OO", "EP", "OBS", "REW", "DONE")
_POLICY_OUT = ("ACT", "LOGP", "VAL")


def race_step_fused_plain(kf, km, arm, ground_z, S, A, R, GG, OO, EP, RST,
                          RSTG, RSTO, *, n_ticks, dt, spec_tail,
                          noise_rows=None, telemetry=False,
                          elim_penalty=1.0, policy_pack=None, obs_rows=None,
                          actn=None, policy_hidden=(64, 64)):
    """Plain PyTorch version of ``race_step_fused`` (any device)."""
    wc = window_consts(kf, km, arm, ground_z, dt, n_ticks)
    tc = tail_consts(spec_tail, ground_z)
    policy = (None if policy_pack is None
              else (obs_rows, policy_pack, policy_hidden, actn))
    out = step_core_plain(wc, tc, S, A, R, GG, OO, EP, RST, RSTG, RSTO,
                          noise_rows=noise_rows, telemetry=telemetry,
                          elim_penalty=elim_penalty, policy=policy)
    res = tuple(out[k] for k in _OUT_ORDER)
    res += (out["INFO"],) if telemetry else ()
    return res + (tuple(out[k] for k in _POLICY_OUT) if policy else ())


# ---------------------------------------------------------------------------
# the kernel's wrapper


class StepConsts(ctypes.Structure):
    """Mirrors ``struct StepConsts`` in csrc/race_step.cuh field for field."""

    _fields_ = [
        ("w", WindowConsts),
        ("pl", PolicyLayout),
        ("N", ctypes.c_int),
        ("Tb", ctypes.c_int),
        ("G", ctypes.c_int),
        ("O", ctypes.c_int),
        ("compete", ctypes.c_int),
        ("per_drone_reward", ctypes.c_int),
        ("end_after_gate", ctypes.c_int),
        ("done_on_collision", ctypes.c_int),
        ("done_on_completion", ctypes.c_int),
        ("telemetry", ctypes.c_int),
        ("episode_len_sec", ctypes.c_float),
        ("inv_freq", ctypes.c_float),
        ("inv_G", ctypes.c_float),
        ("inv_ray", ctypes.c_float),
        ("elim_penalty", ctypes.c_float),
        ("bounds_hi", ctypes.c_float * 3),
        ("dr2", ctypes.c_float),
        ("edge_dr", ctypes.c_float),
        ("beam_dr", ctypes.c_float),
        ("beam_hh", ctypes.c_float),
        ("edge_hh", ctypes.c_float),
        ("sup_dr", ctypes.c_float),
        ("obst_dr", ctypes.c_float),
        ("half_h", ctypes.c_float),
        ("ground_eps", ctypes.c_float),
        ("dd_r2", ctypes.c_float),
        ("dd_hz", ctypes.c_float),
        ("h_lo", ctypes.c_float * MAX_GATES),
        ("h_hi", ctypes.c_float * MAX_GATES),
        ("gz", ctypes.c_float * MAX_GATES),
        ("sup_lo", ctypes.c_float * MAX_GATES),
        ("sup_hi", ctypes.c_float * MAX_GATES),
        ("g_nom", ctypes.c_float * (4 * MAX_GATES)),
        ("o_lo", ctypes.c_float * MAX_OBSTACLES),
        ("o_hi", ctypes.c_float * MAX_OBSTACLES),
        ("o_nom", ctypes.c_float * (3 * MAX_OBSTACLES)),
    ]


class StepPtrs(ctypes.Structure):
    """Mirrors ``struct StepPtrs`` in csrc/race_step.cuh."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "S", "A", "R", "GG", "OO", "EP", "RST", "RSTG", "RSTO", "noise",
        "S_out", "R_out", "GG_out", "OO_out", "EP_out", "OBS", "REW",
        "DONE", "INFO", "OBS_IN", "PP", "ACTN", "ACT", "LOGP", "VAL",
    )]


def ptr(x):
    """The device address of ``x``, or None for no tensor."""
    return None if x is None else x.data_ptr()


def step_consts_struct(wc, tc, telemetry, elim_penalty,
                       layout=None) -> StepConsts:
    out = StepConsts()
    out.w = window_consts_struct(wc)
    if layout is not None:
        out.pl = layout
    for name in ("N", "Tb", "G", "O", "end_after_gate"):
        setattr(out, name, tc[name])
    for name in ("compete", "per_drone_reward", "done_on_collision",
                 "done_on_completion"):
        setattr(out, name, int(tc[name]))
    out.telemetry = int(bool(telemetry))
    out.elim_penalty = float(elim_penalty)
    for name in ("episode_len_sec", "inv_freq", "inv_G", "inv_ray", "dr2",
                 "edge_dr", "beam_dr", "beam_hh", "edge_hh", "sup_dr",
                 "obst_dr", "half_h", "ground_eps", "dd_r2", "dd_hz"):
        setattr(out, name, float(tc[name]))
    out.bounds_hi[:] = tc["bounds_hi"]
    G, O = tc["G"], tc["O"]
    for name in ("h_lo", "h_hi", "gz", "sup_lo", "sup_hi"):
        getattr(out, name)[:G] = [float(v) for v in tc[name]]
    out.g_nom[:4 * G] = [float(v) for pose in tc["g_nom"] for v in pose]
    for name in ("o_lo", "o_hi"):
        getattr(out, name)[:O] = [float(v) for v in tc[name]]
    out.o_nom[:3 * O] = [float(v) for pose in tc["o_nom"] for v in pose]
    return out


def kernel_dims(tc, name):
    """(N, Tb, G, O, T, C) of a step, refused past the kernel's capacity."""
    N, Tb, G, O = tc["N"], tc["Tb"], tc["G"], tc["O"]
    if N > MAX_DRONES or G > MAX_GATES or O > MAX_OBSTACLES:
        raise ValueError(
            f"{name} kernel takes at most {MAX_DRONES} drones, "
            f"{MAX_GATES} gates and {MAX_OBSTACLES} obstacles "
            f"(got {N}, {G}, {O})"
        )
    return N, Tb, G, O, N * Tb, obs_channels(N, G, O, tc["compete"])


def check_policy_pack(pack, C, hidden, device):
    """The layout of a pack for obs size ``C``; raises on a wrong pack."""
    layout, n = policy_layout(C, hidden)
    _check_block("policy_pack", pack, (n,), device)
    return layout


def launch_geometry(kernel, N, Tb, layout=None):
    """How ``kernel`` ("race_step" or "race_rollout") launches for ``N``
    drones and ``Tb`` * 128 envs, with the policy of ``layout`` or
    without: {blocks, threads, smem_bytes (dynamic shared memory per
    block), registers, local_bytes (stack per thread), static_smem_bytes
    (per block)}, as the library itself computes and reports them."""
    consts = StepConsts(N=int(N), Tb=int(Tb))
    if layout is not None:
        consts.pl = layout
    out = (ctypes.c_longlong * 6)()
    fn = getattr(_build.library(kernel), f"adrp_{kernel}_geometry")
    launch_error(kernel, fn(ctypes.addressof(consts), int(layout is not None),
                            out))
    return dict(zip(("blocks", "threads", "smem_bytes", "registers",
                     "local_bytes", "static_smem_bytes"), out))


def race_step_fused(kf, km, arm, ground_z, S, A, R, GG, OO, EP, RST, RSTG,
                    RSTO, *, n_ticks, dt, spec_tail, noise_rows=None,
                    telemetry=False, elim_penalty=1.0, policy_pack=None,
                    obs_rows=None, actn=None, policy_hidden=(64, 64)):
    """One fused race RL step over the packed blocks.

    Returns (S', R', GG', OO', EP', OBS, REW, DONE), then INFO with
    ``telemetry``, then ACT, LOGP, VAL with ``policy_pack`` (a
    ``policy_layout`` pack for ``policy_hidden``, with the previous obs
    ``obs_rows`` (C, T, 128) and draws ``actn`` (4, T, 128); ``A`` is then
    not read). CPU tensors take the plain version. CUDA tensors launch the
    kernel (csrc/race_step.cu: a block per 32-env tile, each agent's window
    on a lane group, the drones side by side, then a thread per agent for
    the tail; with the policy, 512 threads run the tile's MLP first,
    ``launch_geometry``) on the current stream, counting the launch in
    ``race_step_fused.launches`` and, with the policy option, in
    ``race_step_fused.policy_launches``. Any other device raises, and so
    does a call that autograd would record (the kernel has no
    backward)."""
    refuse_grad("race_step_fused", RACE_EAGER, S, A, R, noise_rows,
                policy_pack, obs_rows, actn)
    dev = S.device
    if dev.type == "cpu":
        return race_step_fused_plain(
            kf, km, arm, ground_z, S, A, R, GG, OO, EP, RST, RSTG, RSTO,
            n_ticks=n_ticks, dt=dt, spec_tail=spec_tail,
            noise_rows=noise_rows, telemetry=telemetry,
            elim_penalty=elim_penalty, policy_pack=policy_pack,
            obs_rows=obs_rows, actn=actn, policy_hidden=policy_hidden,
        )
    if dev.type != "cuda":
        raise ValueError(f"race_step_fused: unsupported device {dev}")
    wc = window_consts(kf, km, arm, ground_z, dt, n_ticks)
    tc = tail_consts(spec_tail, ground_z)
    N, Tb, G, O, T, C = kernel_dims(tc, "race_step_fused")
    policy = policy_pack is not None
    for name, x, shape in (
            ("S", S, (S_CHANNELS, T, LANE)),
            ("R", R, (R_CHANNELS, T, LANE)), ("GG", GG, (3 * G, Tb, LANE)),
            ("OO", OO, (2 * O, Tb, LANE)), ("EP", EP, (Tb, LANE)),
            ("RST", RST, (RST_CHANNELS, T, LANE)),
            ("RSTG", RSTG, (3 * G, Tb, LANE)),
            ("RSTO", RSTO, (2 * O, Tb, LANE))):
        _check_block(name, x, shape, dev)
    layout = None
    if policy:
        layout = check_policy_pack(policy_pack, C, policy_hidden, dev)
        _check_block("obs_rows", obs_rows, (C, T, LANE), dev)
        _check_block("actn", actn, (ACT_DIM, T, LANE), dev)
    else:
        _check_block("A", A, (ACT_DIM, T, LANE), dev)
    if noise_rows is not None:
        _check_block("noise_rows", noise_rows,
                     (n_ticks, NOISE_CHANNELS, T, LANE), dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = [empty(S_CHANNELS, T, LANE), empty(R_CHANNELS, T, LANE),
            empty(3 * G, Tb, LANE), empty(2 * O, Tb, LANE),
            empty(Tb, LANE), empty(C, T, LANE), empty(T, LANE),
            empty(Tb, LANE)]
    info = empty(INFO_CHANNELS, T, LANE) if telemetry else None
    pol = ([empty(ACT_DIM, T, LANE), empty(T, LANE), empty(T, LANE)]
           if policy else [None, None, None])
    ptrs = StepPtrs(
        S.data_ptr(), None if policy else A.data_ptr(), R.data_ptr(),
        GG.data_ptr(), OO.data_ptr(), EP.data_ptr(), RST.data_ptr(),
        RSTG.data_ptr(), RSTO.data_ptr(), ptr(noise_rows),
        *[o.data_ptr() for o in outs], ptr(info),
        ptr(obs_rows if policy else None), ptr(policy_pack),
        ptr(actn if policy else None), *[ptr(x) for x in pol],
    )
    consts = step_consts_struct(wc, tc, telemetry, elim_penalty, layout)
    lib = _build.library("race_step")
    with torch.cuda.device(dev):
        err = lib.adrp_race_step(
            ctypes.addressof(ptrs), ctypes.addressof(consts),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    launch_error("race_step", err)
    race_step_fused.launches += 1
    res = tuple(outs) + ((info,) if telemetry else ())
    if policy:
        race_step_fused.policy_launches += 1
        res += tuple(pol)
    return res


race_step_fused.launches = 0
race_step_fused.policy_launches = 0
