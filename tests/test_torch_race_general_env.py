"""Port: the general race env as an RL env, and its trainer, on CPU.

* ``race_rl.batched_rl_race_step`` (shaped reward, early termination,
  autoreset from injected reset draws, telemetry) against the JAX
  package's from a shared state: rewards atol 1e-4, obs and the state at
  tests/test_torch_race_window.py's per-window tolerances on the
  gating-stable envs (``_torch_port.S_ABS``), obs at ``check_blocks``'
  tolerances, discrete outputs equal.
* ``train(general=True)`` and ``train(general=True, fast=True)``: a tiny
  run each, a finite loss, a policy the JAX package's ``ActorCritic``
  reads back; and the general path's argument checks.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.serialization import msgpack_restore as flax_restore

from gym_pybullet_adrp_tpu.envs import race_rl as jrl
from gym_pybullet_adrp_tpu.models.policy import ActorCritic as FlaxAC
from gym_pybullet_adrp_tpu.rl import checkpoint as jck
from gym_pybullet_adrp_tpu_torch import convert, train_race
from gym_pybullet_adrp_tpu_torch.envs import race_rl as prl

from _torch_port import (
    assert_race_S, assert_race_obs, assert_trees, jax_reset_draws,
    mell_stable, race_S, race_specs, tensor, to_port,
)

F32 = np.float32
T = tensor


def _rl_state(jspec, jtrack, B, rng):
    """A JAX RL state of B one-drone envs two hovering steps into their
    episodes (a window whose gating does not depend on rounding), then
    placed: some about to pass gate 0, some on the plane, some at the
    episode's end."""
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    st = jax.vmap(lambda k: jrl.rl_race_reset(jspec, jtrack, k,
                                              dtype=jnp.float32))(keys)
    hover = jax.jit(jax.vmap(lambda s: jrl.rl_race_step(
        jspec, jtrack, s, jnp.zeros((1, 4), jnp.float32))[0]))
    st = hover(hover(st))
    rs = st.race
    g = np.asarray(rs.gates_actual)[:, 0]
    yaw = g[:, 5]
    normal = np.stack([-np.sin(yaw), np.cos(yaw), 0 * yaw], -1)
    height = np.where(g[:, 6] == 0, 1.0, 0.525)
    pos = np.asarray(rs.phys.pos).copy()
    near = np.arange(B) % 3 == 0
    pos[near, 0] = (np.concatenate([g[:, :2], height[:, None]], -1)
                    - 0.05 * normal)[near].astype(F32)
    vel = np.zeros_like(pos)
    vel[near, 0] = 2.0 * normal[near]
    pos[np.arange(B) % 5 == 1, 0, 2] = 0.0
    steps = np.asarray(rs.step_counter).copy()
    steps[np.arange(B) % 7 == 2] = int(jspec.episode_len_sec
                                       * jspec.pyb_freq) - 5
    rs = rs._replace(phys=rs.phys._replace(pos=jnp.asarray(pos),
                                           vel=jnp.asarray(vel)),
                     step_counter=jnp.asarray(steps))
    return st._replace(race=rs)


def test_rl_step_matches_jax():
    pspec, ptrack, jspec, jtrack = race_specs("getting_started", 1)
    B = 32
    rng = np.random.default_rng(4)
    jst = _rl_state(jspec, jtrack, B, rng)
    act = rng.uniform(-1, 1, (B, 1, 4)).astype(F32)
    keys = jax.random.split(jax.random.PRNGKey(21), B)
    ref = jax.jit(lambda s, a, k: jrl.batched_rl_race_step(
        jspec, jtrack, s, a, k, end_after_gate=1, telemetry=True))(
            jst, jnp.asarray(act), keys)
    pl = prl.rl_race_reset(pspec, ptrack, B, device="cpu")
    got = prl.batched_rl_race_step(
        pspec, ptrack, to_port(jst, pl), T(act),
        reset_draws=jax_reset_draws(pspec, keys), end_after_gate=1,
        telemetry=True)
    pst, obs, rew, term, trunc, tel = got
    jrs, jobs, jrew, jterm, jtrunc, jtel = ref
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    done = term.numpy() | trunc.numpy()
    # the step reaches gate passes (early termination), eliminations and
    # timeouts, and leaves some envs running
    assert tel["current_gate"].numpy().any() and done.any() \
        and trunc.numpy().any() and not done.all()
    for k in ("current_gate", "eliminated", "finished"):
        np.testing.assert_array_equal(tel[k].numpy(), np.asarray(jtel[k]))
    np.testing.assert_array_equal(tel["ep_steps"].numpy(),
                                  np.asarray(jtel["ep_steps"], F32))
    # rewards and the stepped envs on gating-stable lanes; the reset ones
    # everywhere
    stable = mell_stable(jst.race.mell)
    np.testing.assert_allclose(rew.numpy()[stable], np.asarray(jrew)[stable],
                               atol=1e-4)
    rows = stable & ~done
    assert stable.all() and rows.sum() >= 0.3 * B
    jpst = to_port(jrs, pl)
    assert_race_S(race_S(pst.race)[:, :, :B], race_S(jpst.race)[:, :, :B],
                  rows[None], "rl step")
    assert_race_obs(obs.numpy()[rows], np.asarray(jobs)[rows], pspec.num_gates,
                pspec.num_obstacles)
    assert_trees(pst._replace(race=None), jpst._replace(race=None),
                 "shaping", {"current_target": 1e-5, "previous_pos": 1e-5},
                 rows=rows)
    assert_trees(pst, jpst, "reset", {"omega": 1e-5}, rows=done)
    assert_race_obs(obs.numpy()[done], np.asarray(jobs)[done], pspec.num_gates,
                pspec.num_obstacles)


@pytest.mark.parametrize("fast", [False, True], ids=["eager", "fast"])
def test_train_general_on_cpu(fast, tmp_path):
    """One tiny PPO iteration of the general env; the written policy reads
    back through the JAX package's checkpoint reader."""
    res = train_race.train(config="twogates", n_envs=16, n_steps=4, iters=1,
                           general=True, fast=fast, device="cpu",
                           log_every=0, out=str(tmp_path / "p.msgpack"))
    m = res["metrics"][0]
    assert np.isfinite([m["loss"], m["mean_reward"]]).all()
    assert m["steps"] == 16 * 4
    assert isinstance(res["env"], train_race.GeneralEnv)
    assert res["env"].fast is fast
    obs_dim = res["env"].spec.obs_size
    fnet = FlaxAC(act_dim=4)
    template = fnet.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_dim)))
    jparams = jck.load_policy(str(tmp_path / "p.msgpack"), template)
    ref = convert.flax_from_actor_critic(res["ts"].params)
    tree = flax_restore((tmp_path / "p.msgpack").read_bytes())
    assert tree.keys() == ref.keys()
    for k, v in ref["params"].items():
        for kk, a in (v.items() if isinstance(v, dict) else [(None, v)]):
            b = jparams["params"][k][kk] if kk else jparams["params"][k]
            np.testing.assert_array_equal(np.asarray(b), a)


def test_general_refuses_row_options():
    with pytest.raises(ValueError, match="one drone"):
        train_race.train(general=True, n_drones=2, device="cpu", iters=0)
    with pytest.raises(ValueError, match="fuse_policy"):
        train_race.train(fast=True, fuse_policy=True, device="cpu", iters=0)
    with pytest.raises(ValueError, match="disturbances"):
        train_race.train(config="level2", fast=True, device="cpu", iters=0)
