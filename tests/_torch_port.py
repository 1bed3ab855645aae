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
import pytest

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


# ---------------------------------------------------------------------------
# the general race env: JAX pytrees <-> the port's NamedTuples


def to_port(x, like):
    """A JAX pytree (vmapped: leaves with the batch axis first) as the
    port's tree of ``like``'s structure, field by field by name (the
    JAX package's extra fields, such as the PRNG key, are left out). A
    leaf with fewer axes than ``like``'s (a drone param shared by the
    drones of an env) is broadcast to ``like``'s shape."""
    import torch

    if hasattr(like, "_fields"):
        return type(like)(*(to_port(getattr(x, f), getattr(like, f))
                            for f in like._fields))
    a = np.asarray(x)
    if a.ndim < like.dim():
        a = a.reshape(a.shape[:1] + (1,) * (like.dim() - a.ndim)
                      + a.shape[1:])
    a = np.broadcast_to(a, tuple(like.shape))
    return torch.from_numpy(np.array(a)).to(like.dtype)


def leaves(tree, prefix=""):
    """[(dotted name, numpy array)] of a NamedTuple tree of tensors or
    arrays."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += leaves(getattr(tree, f), f"{prefix}.{f}")
        return out
    return [(prefix, np.asarray(tree))]


# tolerances of the general race env's comparisons (the test files say
# why each is what it is)
RTOL, ATOL = 1e-5, 1e-6
CTL_ATOL = 1e-5 * 32000.0   # firmware commands: 1e-5 of their range
# gyro biquad, deg/s: an ulp of a pi-sized Euler angle (each package's
# atan2/asin) differenced over one 0.002 s tick is 6.8e-3 deg/s
GYRO_ATOL = 1e-2


def tensor(x):
    import torch

    return torch.from_numpy(np.array(x))


def assert_trees(got, ref, tag, atol=None, rows=None):
    """Leaf by leaf: discrete leaves equal, float leaves at RTOL and ATOL
    or the leaf's entry in ``atol`` (by dotted-name suffix); ``rows``
    (B,) bool keeps those envs only (every leaf has the batch first)."""
    for (name, g), (rname, r) in zip(leaves(got), leaves(ref)):
        assert name == rname, (name, rname)
        r = np.broadcast_to(r, g.shape)
        if rows is not None:
            g, r = g[rows], r[rows]
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r, err_msg=f"{tag}{name}")
            continue
        a = next((v for k, v in (atol or {}).items() if name.endswith(k)),
                 ATOL)
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=a,
                                   err_msg=f"{tag}{name}")


def race_specs(config, n_drones, compete=False):
    """(port spec, port track, JAX spec, JAX track) of a config."""
    import jax.numpy as jnp

    from gym_pybullet_adrp_tpu.envs import race as jrace
    from gym_pybullet_adrp_tpu.utils import config as jconfig
    from gym_pybullet_adrp_tpu.utils import enums as jenums
    from gym_pybullet_adrp_tpu_torch.envs import race as prace
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config
    from gym_pybullet_adrp_tpu_torch.utils.enums import RaceMode

    cfg_p, cfg_j = load_config(config), jconfig.load_config(config)
    mode = RaceMode.COMPETE if compete else RaceMode.COMPARE
    pspec = prace.RaceSpec.from_config(cfg_p, n_drones, mode)
    jspec = jrace.RaceSpec.from_config(cfg_j, n_drones,
                                       jenums.RaceMode(int(mode)))
    return (pspec, prace.track_from_config(cfg_p, n_drones), jspec,
            jrace.track_from_config(cfg_j, n_drones, dtype=jnp.float32))


def jax_reset_draws(spec, keys):
    """The draws ``race.race_reset`` makes from each of ``keys``,
    computed by JAX as it computes them, as the port's ``ResetDraws``."""
    import jax
    import jax.numpy as jnp

    from gym_pybullet_adrp_tpu_torch.envs.race import ResetDraws

    def one(key):
        kg, ko, ki, kp, kr, _ = jax.random.split(key, 6)
        km, kj = jax.random.split(ki)
        f = jnp.float32
        return ResetDraws(
            gate_off=jax.random.uniform(kg, (spec.num_gates, 3), f,
                                        *spec.rg_gates),
            obst_off=jax.random.uniform(ko, (spec.num_obstacles, 2), f,
                                        *spec.rg_obstacles),
            mass_off=jax.random.uniform(km, (spec.num_drones,), f,
                                        *spec.ri_mass),
            j_u=jax.random.uniform(kj, (spec.num_drones, 3), f),
            pos_u=jax.random.uniform(kp, (spec.num_drones, 3), f),
            rot_u=jax.random.uniform(kr, (spec.num_drones, 3), f))

    return ResetDraws(*(tensor(np.asarray(x))
                        for x in jax.vmap(one)(keys)))


def mell_stable(mell, n_ticks=20, dt=1.0 / 500.0):
    """(B,) bool: envs all of whose drones' tick gating over ``n_ticks``
    ticks of length ``dt`` is the same under either rounding
    (``gating_stable`` on the firmware state of the general env, (B, N)
    leaves)."""
    tick = np.asarray(mell.tick, dtype=np.float32)
    S = np.zeros((58,) + tick.shape, np.float32)
    S[53] = tick
    S[54] = np.asarray(mell.last_pos_pid_call)
    S[55] = np.asarray(mell.last_att_pid_call)
    return gating_stable(S, n_ticks, dt).all(axis=-1)


def poly_term_scale(coeffs, t_rel, T_):
    """Per channel (..., 4), the sums of the magnitudes of the terms
    ``eval_poly7`` adds up for position, velocity and acceleration: the
    scale of their rounding, which differs between the port's Horner
    form and the JAX package's powers."""
    safe_T = np.where(T_ > 0, T_, 1.0)[..., None]
    s = np.clip(t_rel[..., None] / safe_T, 0.0, 1.0)[..., None]
    i = np.arange(8)
    c = np.abs(np.asarray(coeffs, dtype=np.float64))
    p = (c * s ** i).sum(-1)
    v = (c * i * s ** np.maximum(i - 1, 0)).sum(-1) / safe_T
    a = (c * i * (i - 1) * s ** np.maximum(i - 2, 0)).sum(-1) / safe_T ** 2
    return p, v, a


def assert_setpoint(got, ref, t_now, rows):
    """The commander's state after ``update_setpoint``: the planner's
    channels at rtol 1e-5 of their terms' magnitudes, the rest equal."""
    use = (~np.asarray(ref.full_state_override)
           & np.asarray(ref.planner_active))[rows][..., None]
    p, v, a = poly_term_scale(np.asarray(ref.coeffs)[rows],
                              t_now[rows] - np.asarray(ref.t_begin)[rows],
                              np.asarray(ref.duration)[rows])
    deg = 180.0 / np.pi
    for f, scale, ch in (("pos", p[..., :3], slice(0, 3)),
                         ("vel", v[..., :3], slice(0, 3)),
                         ("acc", a[..., :3], slice(0, 3)),
                         ("att_rpy", p[..., 3:] * deg, slice(2, 3)),
                         ("att_rate", v[..., 3:] * deg, slice(2, 3))):
        g = getattr(got.setpoint, f).numpy()[rows][..., ch]
        r = np.asarray(getattr(ref.setpoint, f))[rows][..., ch]
        tol = ATOL + RTOL * (np.abs(r) + np.where(use, scale, 0))
        assert (np.abs(g - r) <= tol).all(), f
    assert_trees(got._replace(setpoint=got.setpoint._replace(
        pos=None, vel=None, acc=None, att_rpy=None, att_rate=None)),
        to_port(ref, got)._replace(setpoint=got.setpoint._replace(
            pos=None, vel=None, acc=None, att_rpy=None, att_rate=None)),
        "cmdr", rows=rows)


def race_S(state):
    """The window's S block (numpy) of a general-env race state."""
    from gym_pybullet_adrp_tpu_torch.envs.race_fast import pack_blocks

    B, n = state.rpms.shape[:2]
    return pack_blocks(state, B * n)[0].numpy()


def assert_race_S(got, ref, stable, tag):
    """S blocks at one window's tolerances (``S_ABS``; rpms rtol 3e-4;
    tick and gating rows equal) on the ``stable`` (T, 128) agents."""
    for chans, tol in S_ABS:
        err = np.abs(got[chans][:, stable] - ref[chans][:, stable]).max()
        assert err <= tol, f"{tag} S {chans}: {err} > {tol}"
    rpm = list(range(13, 21))
    rel = (np.abs(got[rpm][:, stable] - ref[rpm][:, stable])
           / np.maximum(np.abs(ref[rpm][:, stable]), 1))
    assert rel.max() <= 3e-4, tag
    gating = list(range(53, 58))
    np.testing.assert_array_equal(got[gating][:, stable],
                                  ref[gating][:, stable], err_msg=tag)


def assert_race_obs(obs, ref, G, O):
    """Race obs (..., C) at ``check_blocks``' tolerances: positions and
    velocities atol 1e-5, angles and world rates 1e-3, the track channels,
    flags and gate id equal, opponent channels 1e-3."""
    track = list(range(12, 12 + 5 * G + 4 * O + 1))
    for chans, tol in (([0, 1, 2, 6, 7, 8], 1e-5),
                       ([3, 4, 5, 9, 10, 11], 1e-3), (track, 0.0),
                       (list(range(track[-1] + 1, obs.shape[-1])), 1e-3)):
        if chans:
            err = np.abs(obs[..., chans] - ref[..., chans]).max()
            assert err <= tol, (chans, err)


@pytest.fixture(autouse=False, scope="module")
def one_thread():
    """One intra-op thread for the module's tests (their tensors are
    small; several test workers share the host's cores), restored
    after."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
