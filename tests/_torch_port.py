"""Shared helpers of the tests/test_torch_*.py files (JAX package vs the
PyTorch port, on CPU).

Why the comparisons mask lanes: XLA on CPU contracts ``a * b + c`` into
fused multiply-adds; the port rounds every operation separately, as the
TPU results of the JAX package suggest the chip does too. The firmware's
tick gating (``cur_time - last_att > 0.002``, ``cur_time - last_pos >
0.01``) compares differences of tick multiples against the tick length
itself, so the two roundings fire the attitude loop on different ticks
for some (tick, last-call) states. ``gating_stable`` simulates both
roundings per lane over a window and marks the lanes where they agree;
the tight tolerances hold on those lanes, the loose ones everywhere.
"""

from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
BLOCKS = ("S", "R", "GG", "OO", "EP")

# ~70% of lanes of a mid-episode window are gating-stable; the tests
# require at least this share so the tight checks cover real data.
MIN_STABLE_SHARE = 0.3


def gating_stable(S, n_ticks=20, dt=1.0 / 500.0):
    """(T, 128) bool: lanes whose attitude/position-loop firing pattern
    over the next ``n_ticks`` ticks is the same whether ``tick * (1/500)
    - last`` is rounded once (fused) or twice (separately)."""
    S = np.asarray(S, dtype=np.float32)
    c = np.float32(1.0) / np.float32(1.0 / dt)
    thr_att, thr_pos = np.float32(0.002), np.float32(0.01)
    tick0 = S[53]
    runs = []
    for fused in (False, True):
        last_pos, last_att = S[54].copy(), S[55].copy()
        seq = []
        for i in range(n_ticks):
            tick = tick0 + np.float32(i)
            cur = (tick * c).astype(np.float32)
            if fused:
                d_att = (tick.astype(np.float64) * np.float64(c)
                         - last_att.astype(np.float64)).astype(np.float32)
                d_pos = (tick.astype(np.float64) * np.float64(c)
                         - last_pos.astype(np.float64)).astype(np.float32)
            else:
                d_att = (cur - last_att).astype(np.float32)
                d_pos = (cur - last_pos).astype(np.float32)
            att = d_att > thr_att
            pos = att & (d_pos > thr_pos)
            last_att = np.where(att, cur, last_att)
            last_pos = np.where(pos, cur, last_pos)
            seq.append((att, pos))
        runs.append(seq)
    stable = np.ones(S.shape[1:], dtype=bool)
    for (a0, p0), (a1, p1) in zip(*runs):
        stable &= (a0 == a1) & (p0 == p1)
    return stable


def env_stable(S, N):
    """(Tb, 128): envs all of whose N drones are gating-stable."""
    st = gating_stable(S)
    return st.reshape(N, -1, st.shape[-1]).all(axis=0)


def numpy_state(state):
    return tuple(np.asarray(getattr(state, k), dtype=np.float32)
                 for k in BLOCKS)


# per-step tolerances on gating-stable lanes, S channels by group
S_ABS = [
    (list(range(0, 10)) + [24, 25, 26], 1e-5),
    ([10, 11, 12, 21, 22, 23, 45, 46, 47, 48], 1e-3),
    (list(range(27, 33)), 1e-3),
    (list(range(33, 39)), 0.2),
    (list(range(39, 45)), 1e-5),
    ([49, 50, 51, 52], 20.0),
]
# the in-kernel policy's outputs (tests/test_policy_fused.py:70-81)
POLICY_ATOL = {"ACT": 2e-5, "LOGP": 2e-4, "VAL": 2e-5}


def check_blocks(N, G, O, envs, got, ref, tag):
    """Compare a race step's (or K steps') output blocks, numpy dicts keyed
    by the kernel's output names, on the lanes of the gating-stable envs
    ``envs`` (Tb, 128). Blocks may carry a leading K axis.
      S: ``S_ABS``, rpms rtol 3e-4, tick/gating rows equal
      R: rows 0-3 equal, the rest atol 1e-5
      OBS: positions and velocities atol 1e-5, angles and world rates
        atol 1e-3, gate/obstacle poses, flags and gate id equal,
        opponent channels atol 1e-3
      REW atol 1e-4; GG, OO, EP, DONE, INFO equal; ACT/LOGP/VAL as
      ``POLICY_ATOL``; and on every lane positions within 2 cm."""
    agents = np.concatenate([envs] * N, axis=0)

    def pick(x, chans, mask):
        return np.take(x, chans, axis=-3)[..., mask]

    for k, x in got.items():
        assert np.isfinite(x).all(), f"{tag} {k}"
    S, rS = got["S"], ref["S"]
    for chans, tol in S_ABS:
        err = np.abs(pick(S, chans, agents) - pick(rS, chans, agents)).max()
        assert err <= tol, f"{tag} S {chans}: {err} > {tol}"
    rpm = list(range(13, 21))
    rel = (np.abs(pick(S, rpm, agents) - pick(rS, rpm, agents))
           / np.maximum(np.abs(pick(rS, rpm, agents)), 1))
    assert rel.max() <= 3e-4, f"{tag} rpms"
    gating = list(range(53, 58))
    np.testing.assert_array_equal(pick(S, gating, agents),
                                  pick(rS, gating, agents), err_msg=tag)
    R, rR = got["R"], ref["R"]
    np.testing.assert_array_equal(pick(R, [0, 1, 2, 3], agents),
                                  pick(rR, [0, 1, 2, 3], agents),
                                  err_msg=tag)
    rest = list(range(4, R.shape[-3]))
    assert np.abs(pick(R, rest, agents)
                  - pick(rR, rest, agents)).max() <= 1e-5, tag
    if "OBS" in got:
        OBS, rOBS = got["OBS"], ref["OBS"]
        C = OBS.shape[-3]
        track = list(range(12, 12 + 5 * G + 4 * O + 1))
        for chans, tol in (([0, 1, 2, 6, 7, 8], 1e-5),
                           ([3, 4, 5, 9, 10, 11], 1e-3),
                           (track, 0.0),
                           (list(range(track[-1] + 1, C)), 1e-3)):
            if chans:
                err = np.abs(pick(OBS, chans, agents)
                             - pick(rOBS, chans, agents)).max()
                assert err <= tol, f"{tag} OBS {chans}: {err} > {tol}"
    assert np.abs(got["REW"] - ref["REW"])[..., agents].max() <= 1e-4, tag
    for k in ("GG", "OO", "EP", "DONE"):
        np.testing.assert_array_equal(got[k][..., envs], ref[k][..., envs],
                                      err_msg=f"{tag} {k}")
    if "INFO" in got:
        np.testing.assert_array_equal(got["INFO"][..., agents],
                                      ref["INFO"][..., agents],
                                      err_msg=f"{tag} INFO")
    for k, tol in POLICY_ATOL.items():
        if k in got:
            err = np.abs(got[k] - ref[k])[..., agents].max()
            assert err <= tol, f"{tag} {k}: {err} > {tol}"
    # every env, stable or not, stays close in position
    assert np.abs(np.take(S, [0, 1, 2], axis=-3)
                  - np.take(rS, [0, 1, 2], axis=-3)).max() <= 2e-2, tag
