"""K race RL steps in one launch (K5): plain PyTorch version + CUDA kernel
wrapper.

Counterpart of gym_pybullet_adrp_tpu/ops/pallas_race_step.py
(``race_rollout`` :750, body ``_rollout_kernel`` :655). Each step is the
fused step of ops/race_step.py (K4), with the state carried from one step
to the next; in policy mode the obs each step writes is the next step's
policy input.

Sequence operands carry a leading K axis: ``A_seq`` (K, 4, T, 128) scaled
action rows, or ``actn_seq`` (K, 4, T, 128) standard-normal draws with
``policy_pack``/``obs_rows`` for the in-kernel policy; ``RST_seq`` (K or
1, 10, T, 128), ``RSTG_seq`` (K or 1, 3G, Tb, 128) and ``RSTO_seq`` (K or
1, 2O, Tb, 128) the per-step reset draws (length 1: the same rows every
step, for deterministic configs); ``noise_rows_seq`` (K, n_ticks, 7, T,
128) the per-tick disturbances.

Returns (S', R', GG', OO', EP', REW (K, T, 128), DONE (K, Tb, 128)
[, OBS (K, C, T, 128) with ``emit_obs``][, INFO (K, 5, T, 128) with
``telemetry``][, ACT (K, 4, T, 128), LOGP (K, T, 128), VAL (K, T, 128)
with the policy]).
"""

import ctypes

import torch

from . import _build
from .race_step import (
    ACT_DIM, INFO_CHANNELS, R_CHANNELS, RST_CHANNELS, _POLICY_OUT,
    check_policy_pack, kernel_dims, launch_error, ptr, step_consts_struct,
    step_core_plain, tail_consts,
)
from .race_window import (
    LANE, NOISE_CHANNELS, S_CHANNELS, _check_block, window_consts,
)


def _seq_len(A_seq, actn_seq, policy):
    seq = actn_seq if policy else A_seq
    if not isinstance(seq, torch.Tensor) or seq.dim() != 4:
        raise ValueError("race_rollout: the action (or draws) sequence must "
                         "be a (K, 4, T, 128) tensor")
    return seq.shape[0]


def race_rollout_plain(kf, km, arm, ground_z, S, A_seq, R, GG, OO, EP,
                       RST_seq, RSTG_seq, RSTO_seq, *, n_ticks, dt,
                       spec_tail, noise_rows_seq=None, telemetry=False,
                       emit_obs=True, policy_pack=None, obs_rows=None,
                       actn_seq=None, elim_penalty=1.0,
                       policy_hidden=(64, 64)):
    """Plain PyTorch version of ``race_rollout``: K steps of
    ``step_core_plain`` (any device)."""
    wc = window_consts(kf, km, arm, ground_z, dt, n_ticks)
    tc = tail_consts(spec_tail, ground_z)
    policy = policy_pack is not None
    K = _seq_len(A_seq, actn_seq, policy)

    def at(seq, k):
        return seq[k if seq.shape[0] > 1 else 0]

    seqs = {key: [] for key in ("REW", "DONE", "OBS", "INFO") + _POLICY_OUT}
    obs = obs_rows
    for k in range(K):
        pol = (obs, policy_pack, policy_hidden, actn_seq[k]) if policy \
            else None
        out = step_core_plain(
            wc, tc, S, None if policy else A_seq[k], R, GG, OO, EP,
            at(RST_seq, k), at(RSTG_seq, k), at(RSTO_seq, k),
            noise_rows=(None if noise_rows_seq is None
                        else noise_rows_seq[k]),
            telemetry=telemetry, elim_penalty=elim_penalty, policy=pol)
        S, R, GG, OO, EP = (out[key] for key in ("S", "R", "GG", "OO", "EP"))
        obs = out["OBS"]
        for key, vals in seqs.items():
            if key in out:
                vals.append(out[key])
    res = (S, R, GG, OO, EP, torch.stack(seqs["REW"]),
           torch.stack(seqs["DONE"]))
    if emit_obs:
        res += (torch.stack(seqs["OBS"]),)
    if telemetry:
        res += (torch.stack(seqs["INFO"]),)
    if policy:
        res += tuple(torch.stack(seqs[key]) for key in _POLICY_OUT)
    return res


class RolloutArgs(ctypes.Structure):
    """Mirrors ``struct RolloutArgs`` in csrc/race_rollout.cu."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "S", "R", "GG", "OO", "EP", "A_seq", "OBS0", "PP", "ACTN_seq",
            "RST_seq", "RSTG_seq", "RSTO_seq", "noise_seq")]
        + [(name, ctypes.c_longlong) for name in (
            "rst_stride", "rstg_stride", "rsto_stride")]
        + [(name, ctypes.c_void_p) for name in (
            "S_out", "R_out", "GG_out", "OO_out", "EP_out", "REW", "DONE",
            "OBS", "INFO", "ACT", "LOGP", "VAL")]
        + [("K", ctypes.c_int)]
    )


def race_rollout(kf, km, arm, ground_z, S, A_seq, R, GG, OO, EP, RST_seq,
                 RSTG_seq, RSTO_seq, *, n_ticks, dt, spec_tail,
                 noise_rows_seq=None, telemetry=False, emit_obs=True,
                 policy_pack=None, obs_rows=None, actn_seq=None,
                 elim_penalty=1.0, policy_hidden=(64, 64)):
    """K fused env steps in one launch (see the module docstring).

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (csrc/race_rollout.cu, one thread per env looping over the K steps)
    on the current stream, counting the launch in
    ``race_rollout.launches``. Any other device raises."""
    dev = S.device
    kw = dict(n_ticks=n_ticks, dt=dt, spec_tail=spec_tail,
              noise_rows_seq=noise_rows_seq, telemetry=telemetry,
              emit_obs=emit_obs, policy_pack=policy_pack, obs_rows=obs_rows,
              actn_seq=actn_seq, elim_penalty=elim_penalty,
              policy_hidden=policy_hidden)
    if dev.type == "cpu":
        return race_rollout_plain(kf, km, arm, ground_z, S, A_seq, R, GG,
                                  OO, EP, RST_seq, RSTG_seq, RSTO_seq, **kw)
    if dev.type != "cuda":
        raise ValueError(f"race_rollout: unsupported device {dev}")
    wc = window_consts(kf, km, arm, ground_z, dt, n_ticks)
    tc = tail_consts(spec_tail, ground_z)
    N, Tb, G, O, T, C = kernel_dims(tc, "race_rollout")
    policy = policy_pack is not None
    K = _seq_len(A_seq, actn_seq, policy)
    for name, x, shape in (
            ("S", S, (S_CHANNELS, T, LANE)),
            ("R", R, (R_CHANNELS, T, LANE)), ("GG", GG, (3 * G, Tb, LANE)),
            ("OO", OO, (2 * O, Tb, LANE)), ("EP", EP, (Tb, LANE))):
        _check_block(name, x, shape, dev)
    strides = []   # floats per step; 0: one block shared by every step
    for name, x, shape in (
            ("RST_seq", RST_seq, (RST_CHANNELS, T, LANE)),
            ("RSTG_seq", RSTG_seq, (3 * G, Tb, LANE)),
            ("RSTO_seq", RSTO_seq, (2 * O, Tb, LANE))):
        if not isinstance(x, torch.Tensor) or x.dim() != 4 \
                or x.shape[0] not in (1, K):
            raise ValueError(f"{name}: expected a (1 or {K}, ...) sequence")
        _check_block(name, x, (x.shape[0],) + shape, dev)
        strides.append(0 if x.shape[0] == 1 else x[0].numel())
    layout = None
    if policy:
        layout = check_policy_pack(policy_pack, C, policy_hidden, dev)
        _check_block("obs_rows", obs_rows, (C, T, LANE), dev)
        _check_block("actn_seq", actn_seq, (K, ACT_DIM, T, LANE), dev)
    else:
        _check_block("A_seq", A_seq, (K, ACT_DIM, T, LANE), dev)
    if noise_rows_seq is not None:
        _check_block("noise_rows_seq", noise_rows_seq,
                     (K, n_ticks, NOISE_CHANNELS, T, LANE), dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    state = [empty(S_CHANNELS, T, LANE), empty(R_CHANNELS, T, LANE),
             empty(3 * G, Tb, LANE), empty(2 * O, Tb, LANE), empty(Tb, LANE)]
    rew, done = empty(K, T, LANE), empty(K, Tb, LANE)
    # in policy mode the obs stream is also the carry between steps
    obs = empty(K, C, T, LANE) if emit_obs or policy else None
    info = empty(K, INFO_CHANNELS, T, LANE) if telemetry else None
    pol = ([empty(K, ACT_DIM, T, LANE), empty(K, T, LANE),
            empty(K, T, LANE)] if policy else [None, None, None])
    args = RolloutArgs(
        S.data_ptr(), R.data_ptr(), GG.data_ptr(), OO.data_ptr(),
        EP.data_ptr(), None if policy else A_seq.data_ptr(),
        ptr(obs_rows if policy else None), ptr(policy_pack),
        ptr(actn_seq if policy else None), RST_seq.data_ptr(),
        RSTG_seq.data_ptr(), RSTO_seq.data_ptr(), ptr(noise_rows_seq),
        *strides, *[x.data_ptr() for x in state], rew.data_ptr(),
        done.data_ptr(), ptr(obs), ptr(info), *[ptr(x) for x in pol], K,
    )
    consts = step_consts_struct(wc, tc, telemetry, elim_penalty, layout)
    lib = _build.library("race_rollout")
    with torch.cuda.device(dev):
        err = lib.adrp_race_rollout(
            ctypes.addressof(args), ctypes.addressof(consts),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    launch_error("race_rollout", err)
    race_rollout.launches += 1
    res = tuple(state) + (rew, done)
    res += (obs,) if emit_obs else ()
    res += (info,) if telemetry else ()
    return res + (tuple(pol) if policy else ())


race_rollout.launches = 0
