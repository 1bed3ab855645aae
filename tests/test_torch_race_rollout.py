"""Port: K4's policy option and the K-step rollout (K5), plain versions,
against the JAX package's race_step_fused(policy_pack=...) and
race_rollout (interpret mode), on CPU; and K5 against K steps of K4 in
the port itself.

Inputs: 128 envs flown 14 steps from reset by a random ActorCritic with
log_std -2 (calm setpoint offsets) through the port's own policy step,
so that the next three windows' tick gating does not depend on FMA
contraction on these tracks (tests/_torch_port.py); numpy-seeded float32
policy draws, actions and the env's reset/disturbance draws, handed to
both sides. The JAX pack is ``pack_policy_params`` of the same weights
(convert.flax_from_actor_critic).

Tolerances (tests/_torch_port.check_blocks), on gating-stable envs, per
step and over K=3 steps alike: S per channel group as the window test,
R rows 0-3 and GG/OO/EP/DONE/INFO equal, OBS kinematics atol 1e-5 /
angles 1e-3, REW atol 1e-4, ACT 2e-5, LOGP 2e-4, VAL 2e-5
(tests/test_policy_fused.py:70-81). Measured: ACT <= 1.3e-7, LOGP
<= 4.8e-7, VAL <= 2.7e-6, OBS kinematics <= 1e-7 over 3 steps.
K5 against K calls of K4, both the port's: equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_adrp_tpu.envs import race_rl_rowfast as jrow
from gym_pybullet_adrp_tpu.ops import pallas_race_step as jprs
from gym_pybullet_adrp_tpu_torch.convert import flax_from_actor_critic
from gym_pybullet_adrp_tpu_torch.envs import race as prace
from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import (
    RowRaceState, make_row_env, pack_policy_params,
)
from gym_pybullet_adrp_tpu_torch.models.policy import ActorCritic
from gym_pybullet_adrp_tpu_torch.ops import race_rollout as rr
from gym_pybullet_adrp_tpu_torch.ops import race_step as rs
from gym_pybullet_adrp_tpu_torch.utils.config import load_config
from gym_pybullet_adrp_tpu_torch.utils.enums import RaceMode

from _torch_port import check_blocks, gating_stable

WARMUP = 14
K = 3
STEP_NAMES = ("S", "R", "GG", "OO", "EP", "OBS", "REW", "DONE", "INFO",
              "ACT", "LOGP", "VAL")
ROLL_NAMES = ("S", "R", "GG", "OO", "EP", "REW", "DONE", "OBS", "INFO",
              "ACT", "LOGP", "VAL")
# (config, drones, hidden, end_after_gate, elim_penalty)
POLICY_CASES = {
    "gs-1drone": ("getting_started", 1, (64, 64), 0, 1.0),
    "twogates-2drone-compete": ("twogates", 2, (64, 64), 1, 2.0),
    "gs-1drone-256x128": ("getting_started", 1, (256, 128), 0, 1.0),
}
ROLLOUT_CASES = {
    "gs-1drone": ("getting_started", 1),
    "gs-2drone-compete": ("getting_started", 2),
    "level2-1drone": ("level2", 1),
}


def _setup(cfg_name, N, hidden=(64, 64), end_after_gate=0,
           elim_penalty=1.0):
    """(env, net, pack, JAX pack, state, obs rows, numpy rng) after the
    warm-up flight."""
    cfg = load_config(cfg_name)
    mode = RaceMode.COMPETE if N > 1 else RaceMode.COMPARE
    spec = prace.RaceSpec.from_config(cfg, N, mode)
    env = make_row_env(spec, prace.track_from_config(cfg, N), 128,
                       device="cpu",
                       generator=torch.Generator().manual_seed(1),
                       per_drone_reward=N > 1, telemetry=True,
                       end_after_gate=end_after_gate,
                       elim_penalty=elim_penalty, policy_hidden=hidden)
    net = ActorCritic(env.obs_size, 4, hidden,
                      generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        net.log_std.fill_(-2.0)
    pack = pack_policy_params(net)
    jpack = jrow.pack_policy_params(
        jax.tree_util.tree_map(jnp.asarray, flax_from_actor_critic(net)))
    rng = np.random.default_rng(0)
    st = env.reset()
    obs = env.initial_obs_rows(st)
    for _ in range(WARMUP):
        st, obs, _ = env.step_policy(st, obs, pack, _normal(rng, env))
    return env, net, pack, jpack, st, obs, rng


def _normal(rng, env, *lead):
    return torch.from_numpy(
        rng.standard_normal(lead + (4, env.T, 128)).astype(np.float32))


def _J(x):
    return None if x is None else jnp.asarray(x.numpy())


def _jax_kw(env):
    noise = ((env.spec.action_noise_std, env.spec.dyn_dist_low,
              env.spec.dyn_dist_high) if env.spec.disturbances else None)
    return dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
                interpret=True, noise=noise, elim_penalty=env.elim_penalty,
                policy_hidden=env.policy_hidden)


def _port_kw(env):
    return dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
                elim_penalty=env.elim_penalty,
                policy_hidden=env.policy_hidden)


def _k_steps(env, st, draws, A=None, pack=None, obs=None, actn=None):
    """K calls of the port's K4 (plain on CPU tensors) with K5's inputs:
    the state before each step and the stacked outputs of every step."""
    def at(x, k):
        return None if x is None else x[k if x.shape[0] > 1 else 0]

    starts, outs = [], []
    for k in range(K):
        starts.append(st)
        pol = {} if pack is None else dict(policy_pack=pack, obs_rows=obs,
                                           actn=actn[k])
        o = rs.race_step_fused(
            env.kf, env.km, env.arm, env.ground_z, st.S,
            None if A is None else A[k], st.R, st.GG, st.OO, st.EP,
            at(draws.RST, k), at(draws.RSTG, k), at(draws.RSTO, k),
            noise_rows=at(draws.noise_rows, k), telemetry=True,
            **pol, **_port_kw(env))
        st = RowRaceState(*o[:5])
        obs = o[5]
        outs.append(o)
    names = STEP_NAMES if pack is not None else STEP_NAMES[:9]
    seqs = {n: torch.stack([o[i] for o in outs])
            for i, n in enumerate(names)}
    return starts, st, seqs


def _stable_envs(env, starts):
    """(Tb, 128): envs whose gating is stable at every step start."""
    ok = np.ones((env.T, 128), dtype=bool)
    for st in starts:
        ok &= gating_stable(st.S.numpy())
    envs = ok.reshape(env.N, -1, 128).all(axis=0)
    assert envs.mean() >= 0.3, f"only {envs.mean():.2f} of envs stable"
    return envs


@pytest.mark.parametrize("name", list(POLICY_CASES))
def test_policy_step_matches_jax(name):
    """K4's policy option, plain, against JAX race_step_fused with the
    in-kernel policy, for two consecutive steps from the port's state."""
    env, _, pack, jpack, st, obs, rng = _setup(*POLICY_CASES[name])

    @jax.jit
    def jstep(S, R, GG, OO, EP, RST, RSTG, RSTO, nr, obs_rows, actn):
        return jprs.race_step_fused(
            env.kf, env.km, env.arm, env.ground_z, S, None, R, GG, OO, EP,
            RST, RSTG, RSTO, noise_rows=nr, telemetry=True,
            policy_pack=jpack, obs_rows=obs_rows, actn=actn,
            **_jax_kw(env))

    for i in range(2):
        actn = _normal(rng, env)
        d = env.step_draws()
        got = rs.race_step_fused(
            env.kf, env.km, env.arm, env.ground_z, st.S, None, st.R, st.GG,
            st.OO, st.EP, d.RST, d.RSTG, d.RSTO, noise_rows=d.noise_rows,
            telemetry=True, policy_pack=pack, obs_rows=obs, actn=actn,
            **_port_kw(env))
        ref = jstep(*[_J(x) for x in (st.S, st.R, st.GG, st.OO, st.EP,
                                      d.RST, d.RSTG, d.RSTO, d.noise_rows,
                                      obs, actn)])
        envs = _stable_envs(env, [st])
        check_blocks(env.N, env.G, env.O, envs,
                     {n: x.numpy() for n, x in zip(STEP_NAMES, got)},
                     {n: np.asarray(x) for n, x in zip(STEP_NAMES, ref)},
                     f"{name} step {i}")
        st, obs = RowRaceState(*got[:5]), got[5]


@pytest.mark.parametrize("name", list(ROLLOUT_CASES))
def test_rollout_matches_jax(name):
    """race_rollout_plain in action mode against JAX race_rollout, K=3
    (level2: randomized reset draws and per-tick disturbances)."""
    env, _, _, _, st, _, rng = _setup(*ROLLOUT_CASES[name])
    A = torch.from_numpy(
        rng.uniform(-0.1, 0.1, (K, 4, env.T, 128)).astype(np.float32))
    d = env.stacked_draws(K)
    got = rr.race_rollout_plain(
        env.kf, env.km, env.arm, env.ground_z, st.S, A, st.R, st.GG, st.OO,
        st.EP, d.RST, d.RSTG, d.RSTO, noise_rows_seq=d.noise_rows,
        telemetry=True, **_port_kw(env))
    ref = jprs.race_rollout(
        env.kf, env.km, env.arm, env.ground_z, _J(st.S), _J(A), _J(st.R),
        _J(st.GG), _J(st.OO), _J(st.EP), _J(d.RST), _J(d.RSTG), _J(d.RSTO),
        noise_rows_seq=_J(d.noise_rows), telemetry=True, **_jax_kw(env))
    starts, _, _ = _k_steps(env, st, d, A=A)
    check_blocks(env.N, env.G, env.O, _stable_envs(env, starts),
                 {n: x.numpy() for n, x in zip(ROLL_NAMES, got)},
                 {n: np.asarray(x) for n, x in zip(ROLL_NAMES, ref)}, name)


def test_rollout_policy_matches_jax():
    """race_rollout_plain in policy mode (obs carried between steps)
    against JAX race_rollout, K=3, two drones in COMPETE."""
    env, _, pack, jpack, st, obs, rng = _setup(
        *POLICY_CASES["twogates-2drone-compete"])
    actn = _normal(rng, env, K)
    d = env.stacked_draws(K)
    got = rr.race_rollout_plain(
        env.kf, env.km, env.arm, env.ground_z, st.S, None, st.R, st.GG,
        st.OO, st.EP, d.RST, d.RSTG, d.RSTO, noise_rows_seq=d.noise_rows,
        telemetry=True, policy_pack=pack, obs_rows=obs, actn_seq=actn,
        **_port_kw(env))
    ref = jprs.race_rollout(
        env.kf, env.km, env.arm, env.ground_z, _J(st.S), None, _J(st.R),
        _J(st.GG), _J(st.OO), _J(st.EP), _J(d.RST), _J(d.RSTG), _J(d.RSTO),
        noise_rows_seq=_J(d.noise_rows), telemetry=True, policy_pack=jpack,
        obs_rows=_J(obs), actn_seq=_J(actn), **_jax_kw(env))
    starts, _, _ = _k_steps(env, st, d, pack=pack, obs=obs, actn=actn)
    check_blocks(env.N, env.G, env.O, _stable_envs(env, starts),
                 {n: x.numpy() for n, x in zip(ROLL_NAMES, got)},
                 {n: np.asarray(x) for n, x in zip(ROLL_NAMES, ref)},
                 "policy rollout")


@pytest.mark.parametrize("mode", ["actions", "policy"])
def test_rollout_plain_equals_k_steps(mode):
    """The port's K5 path equals K calls of its K4 path, bit for bit, on
    randomized level2 draws (actions) and two COMPETE drones (policy)."""
    if mode == "actions":
        env, _, _, _, st, _, rng = _setup("level2", 1)
        A = torch.from_numpy(
            rng.uniform(-1.0, 1.0, (K, 4, env.T, 128)).astype(np.float32))
        pol, kw = {}, dict(A=A)
    else:
        env, _, pack, _, st, obs, rng = _setup(
            *POLICY_CASES["twogates-2drone-compete"])
        actn = _normal(rng, env, K)
        A = None
        pol = dict(policy_pack=pack, obs_rows=obs, actn_seq=actn)
        kw = dict(pack=pack, obs=obs, actn=actn)
    d = env.stacked_draws(K)
    got = rr.race_rollout(
        env.kf, env.km, env.arm, env.ground_z, st.S, A, st.R, st.GG, st.OO,
        st.EP, d.RST, d.RSTG, d.RSTO, noise_rows_seq=d.noise_rows,
        telemetry=True, **pol, **_port_kw(env))
    _, st_k, seqs = _k_steps(env, st, d, **kw)
    for n, x in zip(ROLL_NAMES, got):
        ref = getattr(st_k, n) if n in RowRaceState._fields else seqs[n]
        assert torch.equal(x, ref), (mode, n)


def test_env_rollout_steps_equals_step_calls():
    """RowRaceEnv.rollout_steps (one race_rollout call) equals K
    step_fused calls with the same actions and draws, bit for bit
    (level2: randomized draws and disturbances, actions past the clip)."""
    env, _, _, _, st, _, rng = _setup("level2", 1)
    action = torch.from_numpy(
        rng.uniform(-1.5, 1.5, (K, 128, 4)).astype(np.float32))
    d = env.stacked_draws(K)
    got_st, rew, done = env.rollout_steps(st, action, d)
    env.telemetry = False
    for k in range(K):
        st, _, _, dn = env.step_fused(
            st, action[k], type(d)(d.noise_rows[k], d.RST[k], d.RSTG[k],
                                   d.RSTO[k]))
        assert torch.equal(done[k].reshape(-1) > 0.5, dn), k
    for a, b in zip(got_st, st):
        assert torch.equal(a, b)
    assert rew.shape == (K, env.T, 128)
