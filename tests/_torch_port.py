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
