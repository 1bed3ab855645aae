"""Port: the PPO learner (rl/ppo.py) against the JAX package's
(gym_pybullet_adrp_tpu/rl/ppo.py, optax), on CPU.

Same weights on both sides (convert.flax_from_actor_critic) and the same
numpy-seeded float32 batch. Both compute float32 sums over the batch in
their own order, so the comparisons carry tolerances:
  ppo_loss: the loss to rtol 1e-5; each gradient to 1e-5 of its largest
    magnitude (measured 6.8e-7).
  grouped_update (g=2, three updates, the clip on and off): the params to
    1e-6 of max(their scale, 1) (Adam steps are lr-sized: 3e-4; measured
    6e-8).
  linear_schedule: equal to optax's to float32 rounding.
  train_step with an injected trajectory, n_minibatches=1 (the
    permutation then only reorders a mean), 2 epochs: loss rtol 1e-5,
    params within 1e-6 of max(their scale, 1) (measured 3.2e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gym_pybullet_adrp_tpu.models.policy import ActorCritic as FlaxAC
from gym_pybullet_adrp_tpu.rl import ppo as jppo
from gym_pybullet_adrp_tpu_torch.convert import (
    actor_critic_from_flax, flax_from_actor_critic,
)
from gym_pybullet_adrp_tpu_torch.models.policy import ActorCritic
from gym_pybullet_adrp_tpu_torch.rl import ppo

OBS = 49
CLIP, VF, ENT = 0.2, 0.5, 0.01


def _net(seed=0, hidden=(64, 64)):
    return ActorCritic(OBS, 4, hidden,
                       generator=torch.Generator().manual_seed(seed))


def _jparams(net):
    return jax.tree_util.tree_map(jnp.asarray, flax_from_actor_critic(net))


def _batch(rng, n, ret_scale=3.0):
    """(Transition of numpy float32 obs/action/logp, advantages,
    returns), with old logps off the current policy's so the ratio is
    clipped for some samples."""
    f = np.float32
    obs = rng.normal(0, 1, (n, OBS)).astype(f)
    act = rng.normal(0, 1, (n, 4)).astype(f)
    logp = (-0.5 * (act ** 2 + np.log(2 * np.pi)).sum(-1)
            + rng.normal(0, 0.3, n)).astype(f)
    adv = rng.normal(0.5, 2.0, n).astype(f)
    ret = rng.normal(0, ret_scale, n).astype(f)
    return (obs, act, logp), adv, ret


def _grads_close(got_net, ref_tree, tol, tag, floor=1e-30):
    """Compare a port net's weights with a flax tree, each tensor within
    ``tol`` of max(its largest magnitude, ``floor``)."""
    got = flax_from_actor_critic(got_net)["params"]
    ref = ref_tree["params"]
    for layer in ref:
        for k, r in (ref[layer].items() if isinstance(ref[layer], dict)
                     else [(None, ref[layer])]):
            g = got[layer][k] if k else got[layer]
            r = np.asarray(r)
            scale = max(float(np.abs(r).max()), floor)
            err = float(np.abs(g - r).max())
            assert err <= tol * scale, (tag, layer, k, err, scale)


def _grad_net(net):
    """A copy of ``net`` whose weights are ``net``'s gradients."""
    out = _net()
    with torch.no_grad():
        for p, q in zip(out.parameters(), net.parameters()):
            p.copy_(q.grad)
    return out


def test_ppo_loss_and_grads_match_jax():
    net = _net(1)
    rng = np.random.default_rng(0)
    (obs, act, logp), adv, ret = _batch(rng, 512)
    fnet = FlaxAC(act_dim=4)
    params = _jparams(net)
    jbatch = jppo.Transition(jnp.asarray(obs), jnp.asarray(act),
                             jnp.asarray(logp), None, None, None)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jppo.ppo_loss(fnet, CLIP, VF, ENT, p, jbatch,
                                jnp.asarray(adv), jnp.asarray(ret)),
        has_aux=True)(params)
    batch = ppo.Transition(torch.from_numpy(obs), torch.from_numpy(act),
                           torch.from_numpy(logp), None, None, None)
    loss, aux = ppo.ppo_loss(net, CLIP, VF, ENT, batch,
                             torch.from_numpy(adv), torch.from_numpy(ret))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for a, b in zip(aux, jaux):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5,
                                   atol=1e-7)
    _grads_close(_grad_net(net), jax.tree_util.tree_map(np.asarray, jgrads),
                 1e-5, "grads")


@pytest.mark.parametrize("max_norm,ret_scale", [(0.5, 30.0), (10.0, 0.01)],
                         ids=["clipped", "unclipped"])
def test_grouped_update_matches_optax(max_norm, ret_scale):
    """g=2 gradient accumulation, then optax's clip_by_global_norm and
    adam(3e-4, eps=1e-5), three updates in a row."""
    g, mb = 2, 256
    net = _net(2)
    fnet = FlaxAC(act_dim=4)
    params = _jparams(net)
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adam(3e-4, eps=1e-5))
    opt = tx.init(params)
    ptx = ppo.ClipAdam(3e-4, max_norm)
    popt = ptx.init(list(net.parameters()))
    rng = np.random.default_rng(1)
    norms = []
    for step in range(3):
        micro = [_batch(rng, mb, ret_scale) for _ in range(g)]

        def jloss_fn(p, batch, adv, ret):
            return jppo.ppo_loss(fnet, CLIP, VF, ENT, p, batch, adv, ret)

        xs = (jppo.Transition(*[jnp.stack([jnp.asarray(m[0][i])
                                           for m in micro])
                                for i in range(3)], None, None, None),
              jnp.stack([jnp.asarray(m[1]) for m in micro]),
              jnp.stack([jnp.asarray(m[2]) for m in micro]))
        (params, opt), jl = jppo.grouped_update(jloss_fn, tx, None, g,
                                                params, opt, xs)
        pxs = [(ppo.Transition(*[torch.from_numpy(x) for x in m[0]],
                               None, None, None),
                torch.from_numpy(m[1]), torch.from_numpy(m[2]))
               for m in micro]

        def loss_fn(n, batch, adv, ret):
            return ppo.ppo_loss(n, CLIP, VF, ENT, batch, adv, ret)

        grads = [torch.autograd.grad(loss_fn(net, *x)[0],
                                     list(net.parameters())) for x in pxs]
        norms.append(float(torch.sqrt(sum(
            ((a + b) / 2).pow(2).sum() for a, b in zip(*grads)))))
        popt, pl = ppo.grouped_update(loss_fn, ptx, g, net, popt, pxs)
        np.testing.assert_allclose([float(x) for x in pl], np.asarray(jl),
                                   rtol=1e-5)
        _grads_close(net, jax.tree_util.tree_map(np.asarray, params), 1e-6,
                     f"step {step}", floor=1.0)
    # the case exercises the branch it is named after
    assert all((n >= max_norm) == (max_norm < 1) for n in norms), norms


def test_linear_schedule_matches_optax():
    ref = optax.linear_schedule(init_value=3e-4, end_value=0.0,
                                transition_steps=80)
    ours = ppo.linear_schedule(3e-4, 0.0, 80)
    for count in range(0, 90):
        assert np.float32(ours(count)) == np.float32(ref(count)), count


def test_train_step_matches_jax():
    """One PPO iteration (GAE, 2 epochs of one minibatch) on the same
    injected trajectory through rollout_override."""
    n_envs, n_steps = 64, 8
    net = _net(3)
    params0 = _jparams(net)
    rng = np.random.default_rng(2)
    f = np.float32
    traj_np = dict(
        obs=rng.normal(0, 1, (n_steps, n_envs, OBS)).astype(f),
        action=rng.normal(0, 1, (n_steps, n_envs, 4)).astype(f),
        logp=rng.normal(-5.0, 0.5, (n_steps, n_envs)).astype(f),
        value=rng.normal(0, 1, (n_steps, n_envs)).astype(f),
        reward=rng.normal(0, 1, (n_steps, n_envs)).astype(f),
        done=rng.random((n_steps, n_envs)) < 0.1,
    )
    last_obs = rng.normal(0, 1, (n_envs, OBS)).astype(f)
    fin = np.where(traj_np["done"], 1.0, np.nan).astype(f)
    cfg_kw = dict(n_envs=n_envs, n_steps=n_steps, n_epochs=2,
                  n_minibatches=1, ent_coef=ENT)

    # JAX
    jcfg = jppo.PPOConfig(**cfg_kw)

    def j_override(ts):
        traj = jppo.Transition(**{k: jnp.asarray(v)
                                  for k, v in traj_np.items()})
        ts = ts._replace(last_obs=jnp.asarray(last_obs))
        return ts, traj, {"finished_return": jnp.asarray(fin)}

    jadapter = jppo.EnvAdapter(
        batched_reset=lambda key: (jnp.zeros(n_envs),
                                   jnp.zeros((n_envs, OBS), jnp.float32)),
        step=None, obs_dim=OBS, act_dim=4)
    jinit, jtrain, _ = jppo.make_ppo_core(jcfg, jadapter,
                                          rollout_override=j_override)
    jts = jinit(jax.random.PRNGKey(0))
    jts = jts._replace(params=params0)   # Adam's moments start at zero
    jts, jm = jtrain(jts)

    # port
    cfg = ppo.PPOConfig(**cfg_kw)

    def override(ts):
        traj = ppo.Transition(**{k: torch.from_numpy(v)
                                 for k, v in traj_np.items()})
        ts = ts._replace(last_obs=torch.from_numpy(last_obs))
        return ts, traj, {"finished_return": torch.from_numpy(fin)}

    adapter = ppo.EnvAdapter(
        batched_reset=lambda: (None, torch.zeros((n_envs, OBS))),
        step=None, obs_dim=OBS, act_dim=4)
    init, train_step, _ = ppo.make_ppo_core(cfg, adapter,
                                            rollout_override=override,
                                            device="cpu")
    ts = init(0)
    ts.params.load_state_dict(actor_critic_from_flax(
        jax.tree_util.tree_map(np.asarray, params0)).state_dict())
    ts, m = train_step(ts)

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["mean_reward"]),
                               float(jm["mean_reward"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["mean_episode_return"]),
                               float(jm["mean_episode_return"]))
    _grads_close(ts.params, jax.tree_util.tree_map(np.asarray, jts.params),
                 1e-6, "params", floor=1.0)
