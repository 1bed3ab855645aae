"""Port: differentiable simulation (examples/apg.py, examples/race_grad.py
and autograd through the eager envs) against the JAX package on CPU.

* d(final z)/d(action) through 5 ``rl_step``s (tests/test_diff.py:21):
  finite and all positive, and equal to ``jax.grad`` of the JAX env at
  rtol 1e-4 (float32 through 40 physics substeps; XLA contracts
  multiply-adds, the port rounds each operation), at the zero action and
  at 7 random ones.
* apg's BPTT loss and its gradient on the policy weights (flax-initialised
  weights read into the port's ActorCritic, the same injected start
  offsets, 4 envs x 6 steps) against ``jax.value_and_grad`` of the JAX
  example's loss: loss rtol 1e-5, gradient within 1e-4 of the largest
  gradient entry.
* race_grad's plan gradient at horizon 1 (20 firmware ticks of FULLSTATE
  commands, Mellinger, biquads, tick gating, 20 substeps a step) per env,
  against the jitted JAX gradient vmapped over 8 envs, from shared JAX
  states two hover steps into their episodes, on the envs whose tick
  gating over those 20 ticks does not depend on rounding (``mell_stable``;
  at least half of them): losses at rtol 1e-5, gradients within 1e-3 of
  the env's largest entry (the D-term amplifies ulp differences). From
  the reset, where no env's window is ``mell_stable``: finite, non-zero
  gradients and the losses within 1e-2.
* ``apg.run(iters=25, horizon=20, n_envs=8)`` meets tests/test_diff.py's
  criterion (the best loss below 0.75 x the first); ``race_grad.run(
  iters=8, horizon=10)`` its criterion (the last loss below the first),
  marked ``slow``: eight BPTT iterations through the same step the
  horizon-1 comparison covers, ~50 s on the CPU.
* A gradient through each hand-written kernel route (fast_hover, K1, K2
  and its A/B variants, K3 and race_fast, K4, K5) raises instead of
  returning zeros; the routes run as before under ``torch.no_grad()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_adrp_tpu.envs import race_rl as jrl
from gym_pybullet_adrp_tpu.envs import rl as jrlenv
from gym_pybullet_adrp_tpu.envs.core import AviaryConfig as JAviaryConfig
from gym_pybullet_adrp_tpu.models import drone as jdrone
from gym_pybullet_adrp_tpu.models.policy import ActorCritic as FlaxAC
from gym_pybullet_adrp_tpu.utils import enums as jenums
from gym_pybullet_adrp_tpu_torch import convert
from gym_pybullet_adrp_tpu_torch.envs import race_rl as prl
from gym_pybullet_adrp_tpu_torch.envs import rl as rlenv
from gym_pybullet_adrp_tpu_torch.examples import apg, race_grad
from gym_pybullet_adrp_tpu_torch.models.drone import drone_params

from _torch_port import (
    jax_reset_draws, mell_stable, race_specs, tensor, to_port,
)

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
F32 = np.float32
JCFG = jrlenv.RLConfig(aviary=JAviaryConfig(ctrl_freq=30),
                       act_type=jenums.ActionType.RPM)
JPARAMS = jdrone.drone_params(jenums.DroneModel.CF2X)


def _jax_final_z(action):
    st = jrlenv.rl_reset(JCFG, apg.INIT_XYZS, apg.INIT_RPYS)

    def body(st, _):
        st, *_ = jrlenv.rl_step(JCFG, JPARAMS, st, action)
        return st, None

    st, _ = jax.lax.scan(body, st, None, length=5)
    return st.core.phys.pos[0, 2]


def test_env_step_gradient_matches_jax():
    rng = np.random.default_rng(0)
    acts = np.concatenate([np.zeros((1, 1, 4)),
                           rng.uniform(-0.8, 0.8, (7, 1, 4))]).astype(F32)
    ref = np.asarray(jax.jit(jax.vmap(jax.grad(_jax_final_z)))(acts))
    params = drone_params(device="cpu")
    a = tensor(acts).requires_grad_(True)
    st = rlenv.rl_reset(apg.RL_CFG, apg.INIT_XYZS, apg.INIT_RPYS, 8,
                        device="cpu")
    for _ in range(5):
        st, *_ = rlenv.rl_step(apg.RL_CFG, params, st, a)
    g, = torch.autograd.grad(st.core.phys.pos[:, 0, 2].sum(), a)
    g = g.numpy()
    assert np.isfinite(g).all()
    # more rpm on every motor -> higher altitude
    assert (g[0] > 0).all(), g[0]
    np.testing.assert_allclose(g, ref, rtol=1e-4)


def _jax_apg_loss(net_params, dz, horizon):
    """examples/apg.py's loss_fn with injected start offsets, vmapped."""
    network = FlaxAC(act_dim=4)
    target = jnp.asarray(apg.TARGET)

    def step(carry, _):
        state, p = carry
        obs = jrlenv.compute_obs(JCFG, state).reshape(-1)
        mean, _, _ = network.apply(p, obs[None])
        action = jnp.tanh(mean).reshape(1, 4)
        state, _, _, _, _ = jrlenv.rl_step(JCFG, JPARAMS, state, action)
        pos, rpy = state.core.phys.pos[0], state.core.phys.rpy[0]
        cost = (jnp.sum((pos - target) ** 2)
                + 0.1 * jnp.sum(state.core.phys.vel[0] ** 2)
                + 0.1 * jnp.sum(rpy[:2] ** 2) + 1e-3 * jnp.sum(action ** 2))
        return (state, p), cost

    def one(d):
        st = jrlenv.rl_reset(JCFG, apg.INIT_XYZS, apg.INIT_RPYS)
        st = st._replace(core=st.core._replace(phys=st.core.phys._replace(
            pos=st.core.phys.pos.at[0, 2].add(d))))
        _, costs = jax.lax.scan(step, (st, net_params), None,
                                length=horizon)
        return costs.mean()

    return jax.vmap(one)(dz).mean()


def test_apg_loss_and_gradient_match_jax():
    horizon = 6
    dz = np.random.default_rng(1).uniform(-0.05, 0.3, 4).astype(F32)
    obs0 = jnp.zeros((1, apg.RL_CFG.obs_size), jnp.float32)
    fparams = FlaxAC(act_dim=4).init(jax.random.PRNGKey(0), obs0)
    # a larger policy head than the init's 0.01 gain, so the actions vary
    head = fparams["params"]["Dense_2"]
    fparams = {"params": {**fparams["params"], "Dense_2": {
        "kernel": head["kernel"] * 30.0, "bias": head["bias"]}}}
    loss, grads = jax.jit(jax.value_and_grad(_jax_apg_loss),
                          static_argnums=2)(fparams, jnp.asarray(dz),
                                            horizon)
    net = convert.actor_critic_from_flax(fparams)
    params = drone_params(device="cpu")
    got = apg.loss_fn(net, params, tensor(dz), horizon)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    ref = convert.actor_critic_from_flax(grads)
    for (name, p), r in zip(net.named_parameters(), ref.parameters()):
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        scale = max(np.abs(r.detach().numpy()).max(), 1e-12)
        assert np.abs(g - r.detach().numpy()).max() <= 1e-4 * scale, name
    assert np.abs(net.pi_out.weight.grad.numpy()).max() > 0


def _jax_plan_loss(jspec, jtrack, waypoint):
    """examples/race_grad.py's loss of one env's plan from a given state."""
    def jloss(actions, st):
        def body(s, a):
            s, *_ = jrl.rl_race_step(jspec, jtrack, s, a[None])
            return s, s.race.phys.pos[0]

        _, traj = jax.lax.scan(body, st, jnp.tanh(actions))
        d = jnp.sqrt(jnp.sum((traj - waypoint) ** 2, axis=-1) + 1e-8)
        return d.min() + d[-1] + 1e-3 * jnp.sum(jnp.tanh(actions) ** 2)

    return jax.jit(jax.vmap(jax.value_and_grad(jloss)))


def _port_plan_loss(pspec, track, start, acts, waypoint):
    a = tensor(acts.transpose(1, 0, 2)).requires_grad_(True)
    _, traj = race_grad.rollout(pspec, track, start, torch.tanh(a),
                                [None] * acts.shape[1])
    loss = race_grad.plan_loss(traj, a, tensor(waypoint))
    g, = torch.autograd.grad(loss.sum(), a)
    return loss.detach().numpy(), g.numpy().transpose(1, 0, 2)


def test_race_plan_gradient_matches_jax():
    """The plan gradient per env from shared JAX states two hover steps
    into their episodes, over a window whose tick gating does not depend
    on rounding: tight. From the reset, whose window's gating does (no
    env's 20 or 40 ticks from there are ``mell_stable``, and the
    firmware's D-term turns the other firing ticks into ~1e-4 m a step):
    finite, the losses within 1e-2."""
    pspec, ptrack, jspec, jtrack = race_specs("twogates", 1)
    B = 8
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    jst0 = jax.vmap(lambda k: jrl.rl_race_reset(jspec, jtrack, k,
                                                dtype=jnp.float32))(keys)
    hover = jax.jit(jax.vmap(lambda s: jrl.rl_race_step(
        jspec, jtrack, s, jnp.zeros((1, 4), jnp.float32))[0]))
    jst = hover(hover(jst0))
    waypoint = race_grad.gate_waypoint(ptrack)
    rng = np.random.default_rng(2)
    track = race_grad.race_mod.track_tensors(ptrack, "cpu")
    like = prl.rl_race_reset(pspec, ptrack, B, jax_reset_draws(pspec, keys),
                             device="cpu")
    jfn = _jax_plan_loss(jspec, jtrack, waypoint)

    acts = rng.uniform(-0.5, 0.5, (B, 1, 4)).astype(F32)
    jl, jg = (np.asarray(x) for x in jfn(jnp.asarray(acts), jst))
    loss, g = _port_plan_loss(pspec, track, to_port(jst, like), acts,
                              waypoint)
    rows = mell_stable(jst.race.mell, 20)
    assert rows.mean() >= 0.5, rows
    np.testing.assert_allclose(loss[rows], jl[rows], rtol=1e-5)
    scale = np.abs(jg).max(axis=(1, 2), keepdims=True)
    assert (np.abs(g - jg) <= 1e-3 * scale)[rows].all()
    assert (np.abs(g).max(axis=(1, 2)) > 0).all()

    jl, jg = (np.asarray(x) for x in jfn(jnp.asarray(acts), jst0))
    loss, g = _port_plan_loss(pspec, track, like, acts, waypoint)
    assert not mell_stable(jst0.race.mell, 20).any()
    np.testing.assert_allclose(loss, jl, atol=1e-2)
    assert np.isfinite(g).all() and (np.abs(g).max(axis=(1, 2)) > 0).all()


def test_apg_reduces_loss():
    """tests/test_diff.py:40 on the port."""
    losses, dist = apg.run(iters=25, horizon=20, n_envs=8, lr=0.02,
                           device="cpu", verbose=False)
    assert np.isfinite(losses).all() and np.isfinite(dist)
    assert min(losses) < losses[0] * 0.75, (losses[0], min(losses))


@pytest.mark.slow
def test_race_grad_reduces_loss():
    """tests/test_diff.py:54 on the port."""
    losses, gates, closest = race_grad.run(iters=8, horizon=10, lr=0.05,
                                           verbose=False, device="cpu")
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], (losses[0], losses[-1])


def _kernel_routes():
    """(name, call(grad_tensor)) of every hand-written kernel route, each
    called with one input that requires grad."""
    from gym_pybullet_adrp_tpu_torch.envs import fast_hover, race_fast
    from gym_pybullet_adrp_tpu_torch.ops import (
        hover_step as hs, hover_variants as hv, race_rollout, race_step,
        race_window,
    )

    P = drone_params(device="cpu")
    st = fast_hover.reset_packed([0.0, 0.0, 0.1125], 128, device="cpu")
    rpm = torch.full((4, 1, 128), 14000.0)
    S, W = torch.zeros(58, 1, 128), torch.zeros(57, 1, 128)
    pspec, ptrack, _, _ = race_specs("twogates", 1)
    rs = race_grad.race_mod.race_reset(pspec, ptrack, 2, device="cpu",
                                       generator=torch.Generator())
    ids = torch.zeros((2, 1), dtype=torch.int32)
    step = fast_hover.make_step(P, 128, device="cpu")
    tail = dict(n_ticks=20, dt=0.002, spec_tail=None)
    return [
        ("fast_hover.step", lambda x: step(st, x), torch.zeros(4, 1, 128)),
        ("ctrl_step_packed", lambda x: hs.ctrl_step_packed(
            P, x, rpm, 8, 1 / 240), st.packed),
        ("ctrl_step_packed", lambda x: hs.ctrl_step_packed(
            P, st.packed, x, 8, 1 / 240), rpm),
        ("hover_rollout", lambda x: hs.hover_rollout(P, x, 3, 2),
         st.packed),
        ("hover_rollout", lambda x: hs.hover_rollout(
            P, st.packed, 3, 2, actions=x), torch.zeros(2, 4, 1, 128)),
        ("hover_rollout_v2", lambda x: hv.hover_rollout_v2(P, x, 3, 2),
         st.packed),
        ("hover_rollout_v3", lambda x: hv.hover_rollout_v3(P, x, 3, 2),
         st.packed),
        ("race_window", lambda x: race_window.race_window(
            3.16e-10, 7.94e-12, 0.0397, 0.0125, x, W), S),
        ("race_fast", lambda x: race_fast.batched_race_step_fast(
            pspec, ptrack, rs, ids, x), torch.zeros(2, 1, 14)),
        ("race_step_fused", lambda x: race_step.race_step_fused(
            0, 0, 0, 0, x, None, None, None, None, None, None, None, None,
            **tail), S),
        ("race_step_fused", lambda x: race_step.race_step_fused(
            0, 0, 0, 0, S, None, None, None, None, None, None, None, None,
            policy_pack=x, **tail), torch.zeros(8)),
        ("race_rollout", lambda x: race_rollout.race_rollout(
            0, 0, 0, 0, x, None, None, None, None, None, None, None, None,
            **tail), S),
    ]


def test_kernel_routes_refuse_autograd():
    """Each route's plain version (the tensors lie on the CPU) raises
    where autograd would record, naming the eager path; under no_grad the
    hover routes still run."""
    for name, call, x in _kernel_routes():
        with pytest.raises(RuntimeError, match="has no backward"):
            call(x.clone().requires_grad_(True))
    routes = dict((n, (c, x)) for n, c, x in _kernel_routes()[:7])
    with torch.no_grad():
        for name in ("fast_hover.step", "ctrl_step_packed", "hover_rollout",
                     "hover_rollout_v2", "hover_rollout_v3"):
            call, x = routes[name]
            call(x.clone().requires_grad_(True))
    # a tensor that does not require grad passes with grad enabled
    call, x = routes["ctrl_step_packed"]
    assert call(x).shape == (13, 1, 128)
