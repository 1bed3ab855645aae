"""Port: the league and proximity-shaping options of the race trainer
(train_race.py; the JAX script's scripts/train_race.py:222-330,
:400-410), on CPU, without the JAX package's interpret-mode kernel.

* ``prox_shape`` against the JAX script's formula (written here in
  jax.numpy as the script writes it) on random COMPETE obs: atol 1e-6
  (float32 sqrt and clip, rounded alike but not fused alike).
* ``pool_forward`` (one batched matmul per layer) against
  ``jax.vmap(flax ActorCritic.apply)`` on the same stacked weights:
  atol 1e-5 (float32 dot products of 67-64 terms summed in other
  orders).
* The league step: env block i of B/P flies pool member i's clipped
  mean action on drones 1..N-1, the learner's action on drone 0, in
  one row-env step; the PPO rows are drone 0's obs and reward
  (exactly, the same tensors).
* ``refresh_pool`` and ``train(league, league_refresh=1)``: slot 0
  equals the learner (``torch.equal``), the other slots unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_adrp_tpu.models.policy import ActorCritic as FlaxAC
from gym_pybullet_adrp_tpu.rl import checkpoint as jck
from gym_pybullet_adrp_tpu_torch import train_race
from gym_pybullet_adrp_tpu_torch.envs import race as prace
from gym_pybullet_adrp_tpu_torch.rl import checkpoint as pck
from gym_pybullet_adrp_tpu_torch.utils.config import load_config
from gym_pybullet_adrp_tpu_torch.utils.enums import RaceMode

from _torch_port import REPO

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
POOL = [str(REPO / f"results/{p}.msgpack")
        for p in ("level3_mastery", "level3_selfplay", "seedsweep/best",
                  "captrain/w64_s4")]


def jax_prox_shape(obs, reward, w, radius, n_drones, obs_size):
    """scripts/train_race.py:222-240."""
    base = obs_size - 6 * (n_drones - 1)
    px, py = obs[..., 0], obs[..., 1]
    d2min = None
    for j in range(n_drones - 1):
        ox = obs[..., base + 6 * j]
        oy = obs[..., base + 6 * j + 1]
        d2 = (px - ox) ** 2 + (py - oy) ** 2
        d2min = d2 if d2min is None else jnp.minimum(d2min, d2)
    pen = w * jnp.clip(1.0 - jnp.sqrt(d2min) / radius, 0.0, 1.0)
    return reward - pen


@pytest.mark.parametrize("n", [2, 4])
def test_prox_shape_matches_jax(n):
    rng = np.random.default_rng(n)
    C = 55 + 6 * (n - 2)
    obs = rng.uniform(-1.0, 1.0, (64, n, C)).astype(np.float32)
    # half the opponents within the radius
    obs[:32, :, 49:] = obs[:32, :, :1] + rng.uniform(-0.2, 0.2, (32, n, 1))
    rew = rng.normal(size=(64, n)).astype(np.float32)
    ref = jax_prox_shape(jnp.asarray(obs), jnp.asarray(rew), 0.1, 0.3, n, C)
    got = train_race.prox_shape(torch.from_numpy(obs),
                                torch.from_numpy(rew), 0.1, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    assert (got.numpy() < rew).any()


def test_pool_forward_matches_flax():
    fnet = FlaxAC(act_dim=4)
    tmpl = fnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 67)))
    flax_pool = [jck.load_policy(p, tmpl) for p in POOL]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *flax_pool)
    obs = np.random.default_rng(0).normal(size=(4, 96, 67)).astype(
        np.float32)
    ref = jax.vmap(lambda p, o: fnet.apply(p, o)[0])(stacked,
                                                      jnp.asarray(obs))
    pool = train_race.load_pool(POOL, (64, 64), 67, "cpu")
    got = train_race.pool_forward(pool, torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_league_step_blocks_and_learner_rows():
    cfg = load_config("level3")
    spec = prace.RaceSpec.from_config(cfg, 4, RaceMode.COMPETE)
    track = prace.track_from_config(cfg, 4)
    B, P, C = 128, len(POOL), spec.obs_size
    gen = torch.Generator().manual_seed(0)
    env, adapter, _ = train_race._row_adapter(
        spec, track, B, 8, "cpu", gen, 0, 3.0, (64, 64), False, 16,
        league=POOL)
    state, obs0 = adapter.batched_reset()
    assert obs0.shape == (B, C) and torch.equal(obs0, state.obs[:, 0])
    seen = {}
    step = env.step

    def spy(st, act):
        seen["act"] = act.clone()
        return step(st, act)

    env.step = spy
    learner = torch.rand((B, 4), generator=gen) * 2 - 1
    draws = gen.get_state()
    new, obs, rew, done = adapter.step(state, learner)
    act = seen["act"]
    assert act.shape == (B, 4, 4)
    assert torch.equal(act[:, 0], learner)
    nets = [pck.load_policy(p, "cpu") for p in POOL]
    for b in (0, B // P - 1, B // P, B - 1):
        with torch.no_grad():
            mean = nets[b // (B // P)](state.obs[b, 1:])[0]
        torch.testing.assert_close(act[b, 1:], torch.clamp(mean, -1, 1),
                                   atol=1e-5, rtol=0)
    # the PPO rows are drone 0's
    assert obs.shape == (B, C) and torch.equal(obs, new.obs[:, 0])
    assert rew.shape == (B,) and done.shape == (B,)
    env.step = step
    gen.set_state(draws)            # the same disturbances again
    _, full_obs, full_rew, _ = step(state.row, act)
    assert torch.equal(obs, full_obs[:, 0]) and torch.equal(rew,
                                                             full_rew[:, 0])


def test_league_trains_and_refreshes_slot_0():
    res = train_race.train(config="level3", n_envs=128, n_steps=8, iters=1,
                           n_drones=4, compete=True, end_after_gate=0,
                           league=",".join(POOL[:2]), league_refresh=1,
                           prox_penalty=0.1, device="cpu", log_every=0)
    m = res["metrics"][0]
    assert np.isfinite(m["loss"]) and m["steps"] == 128 * 8
    pool, net = res["ts"].env_state.pool, res["ts"].params
    assert res["ts"].last_obs.shape == (128, 67)
    frozen = train_race.load_pool(POOL[:2], (64, 64), 67, "cpu")
    layers = list(net.pi) + [net.pi_out]
    for i, lay in enumerate(layers):
        assert torch.equal(pool.weight[i][0], lay.weight.T)
        assert torch.equal(pool.bias[i][0, 0], lay.bias)
        assert torch.equal(pool.weight[i][1], frozen.weight[i][1])
        assert not torch.equal(pool.weight[i][0], frozen.weight[i][0])
