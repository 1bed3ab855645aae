"""Port: parallel/hosts.py and parallel/distributed.py, and the collective
hooks of rl/ppo.py, against the JAX package, on the CPU.

The JAX side runs here on the conftest's 8 virtual CPU devices (meshes of
2); the port's side runs in 2 rank processes on gloo
(tests/_torch_dist_worker.py, no JAX), started once for the module and
fed numpy inputs drawn from a seed. Tolerances, stated before the first
run:
  grouped_update (g=2 on each of 2 ranks, sgd(1.0), JAX's shard_map on
    a 2-device mesh): both ranks' params equal by torch.equal; each within
    rtol 1e-5 / atol 1e-6 of JAX's (tests/test_rl.py:208-283); exactly one
    all-reduce.
  make_distributed_ppo's step on injected per-rank trajectories (2
    epochs of one minibatch) against JAX's make_ppo_core(axis_name="dp")
    under shard_map: loss rtol 1e-5, params within 1e-6 of max(their
    largest entry, 1) (tests/test_torch_ppo.py's PPO tolerances).
  Replicas after 2 steps (grad_accum=2, 4 minibatches, 2 epochs): equal
    by torch.equal; one gradient all-reduce per update group.
  The tp=2 ActorCritic: forward and gradients within 1e-6 of max(the
    largest entry, 1) of the unsharded module's and flax's.
  make_pjit_ppo (dp=1 x tp=2 and dp=2 x tp=1) against the port's
    single-process make_ppo, 2 steps: loss rtol 1e-4, params rtol 2e-4 /
    atol 2e-6 (tests/test_rl.py:313-347).
  The sharded rollouts: each rank's local reward sum equal by
    torch.equal to the same seed's run alone; the reduced sum finite, the
    same on both ranks and equal to the sum of the locals.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gym_pybullet_adrp_tpu.models.policy import ActorCritic as FlaxAC
from gym_pybullet_adrp_tpu.parallel import distributed as jdist
from gym_pybullet_adrp_tpu.rl import ppo as jppo
from gym_pybullet_adrp_tpu_torch.convert import (
    actor_critic_flax_names, flax_from_actor_critic,
)
from gym_pybullet_adrp_tpu_torch.models.policy import ActorCritic
from gym_pybullet_adrp_tpu_torch.parallel import distributed, hosts
from gym_pybullet_adrp_tpu_torch.rl import ppo
from gym_pybullet_adrp_tpu_torch.scaling import free_port

from _torch_port import REPO
from _torch_port import one_thread  # noqa: F401

sys.path.insert(0, str(REPO / "tests"))
import _torch_dist_worker as W  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")
CASES = ("grouped", "injected", "e2e", "accum", "tp_forward", "pjit_tp",
         "pjit_dp", "race", "hover_roll")
OBS_SMALL = 6
TIMEOUT = 180


class Cluster:
    """``world`` worker ranks on gloo, started at once; ``results()``
    waits for them (at most ``TIMEOUT`` s, killing them on failure) and
    returns each rank's outputs."""

    def __init__(self, world, tmp, inputs, cases):
        self.tmp = tmp
        np.savez(tmp / "in.npz", **inputs)
        port = free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, str(REPO / "tests/_torch_dist_worker.py"),
             str(r), str(world), str(port), str(tmp / "in.npz"), str(tmp),
             ",".join(cases)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self.out = None

    def results(self):
        if self.out is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=TIMEOUT)[0])
            finally:
                self.kill()
            ok = all(p.returncode == 0 for p in self.procs)
            assert ok, "\n".join(f"--- rank {r} ---\n{lg[-3000:]}"
                                 for r, lg in enumerate(logs))
            self.out = [dict(np.load(self.tmp / f"rank{r}.npz"))
                        for r in range(len(self.procs))]
        return self.out

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _net(seed, obs_dim, rng):
    """An ActorCritic with random biases and log-std (the init zeroes
    them), so that every tensor carries data."""
    net = ActorCritic(obs_dim, 4, generator=torch.Generator().manual_seed(
        seed))
    with torch.no_grad():
        for name, p in net.named_parameters():
            if not name.endswith("weight"):
                p.copy_(torch.from_numpy(
                    rng.uniform(-0.1, 0.1, p.shape).astype(np.float32)))
    return net


def _weights(prefix, net):
    return {prefix + k: v.numpy().copy() for k, v in
            net.state_dict().items()}


def _inputs():
    rng = np.random.default_rng(0)
    f = np.float32
    g, mb = W.GROUPED["g"], W.GROUPED["mb"]
    n = 2 * g
    obs_hover = W.hover_setup()[0].obs_size
    inp = _weights("grouped/w/", _net(0, OBS_SMALL, rng))
    inp.update({
        "grouped/obs": rng.normal(0, 1, (n, mb, OBS_SMALL)).astype(f),
        "grouped/action": rng.normal(0, 1, (n, mb, 4)).astype(f),
        "grouped/logp": (0.1 * rng.normal(0, 1, (n, mb))).astype(f),
        "grouped/adv": rng.normal(0, 1, (n, mb)).astype(f),
        "grouped/ret": rng.normal(0, 1, (n, mb)).astype(f),
    })
    e, t = W.INJECTED["n_envs"], W.INJECTED["n_steps"]
    inp.update(_weights("injected/w/", _net(1, obs_hover, rng)))
    done = rng.random((2, t, e)) < 0.1
    inp.update({
        "injected/obs": rng.normal(0, 1, (2, t, e, obs_hover)).astype(f),
        "injected/action": rng.normal(0, 1, (2, t, e, 4)).astype(f),
        "injected/logp": rng.normal(-5.0, 0.5, (2, t, e)).astype(f),
        "injected/value": rng.normal(0, 1, (2, t, e)).astype(f),
        "injected/reward": rng.normal(0, 1, (2, t, e)).astype(f),
        "injected/done": done,
        "injected/last_obs": rng.normal(0, 1, (2, e, obs_hover)).astype(f),
        "injected/fin": np.where(done, 1.0, np.nan).astype(f),
    })
    inp.update(_weights("tpfwd/w/", _net(2, OBS_SMALL, rng)))
    inp.update({
        "tpfwd/obs": rng.normal(0, 1, (32, OBS_SMALL)).astype(f),
        "tpfwd/wm": rng.normal(0, 1, (32, 4)).astype(f),
        "tpfwd/wv": rng.normal(0, 1, (32,)).astype(f),
    })
    return inp


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory, inputs):
    c = Cluster(2, tmp_path_factory.mktemp("dist"), inputs, CASES)
    yield c
    c.kill()


def _state(prefix, inp):
    return {k[len(prefix):]: v for k, v in inp.items()
            if k.startswith(prefix)}


def _flax_tree(state):
    """The flax params tree of a port state dict (numpy)."""
    net = ActorCritic(state["pi.0.weight"].shape[1], 4)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return jax.tree_util.tree_map(jnp.asarray, flax_from_actor_critic(net))


def _as_port(tree, like_state):
    """A flax params tree as numpy arrays keyed by the port's names."""
    p = tree["params"]
    net = ActorCritic(like_state["pi.0.weight"].shape[1], 4)
    out = {}
    for name, (mod, leaf) in actor_critic_flax_names(net).items():
        x = np.asarray(p[mod] if leaf is None else p[mod][leaf])
        out[name] = x.T if leaf == "kernel" else x
    return out


def _close_to_scale(got, ref, tol, tag):
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1.0)
        err = float(np.abs(got[k] - r).max())
        assert err <= tol * scale, (tag, k, err, scale)


# ---------------------------------------------------------------------------
# hosts


def test_hosts_single_process_noop():
    """The port's tests/test_utils.py:147: no cluster -> False, the env
    slice is the whole batch; a world-1 group gives a 1-rank mesh, and
    make_mesh refuses more ranks than the world has."""
    assert hosts.ensure_initialized() is False
    assert hosts.local_env_slice(64) == (0, 64)
    assert hosts.process_count() == 1
    addr = f"127.0.0.1:{free_port()}"
    assert hosts.ensure_initialized(addr, 1, 0, backend="gloo") is True
    try:
        assert hosts.ensure_initialized(addr, 1, 0) is True   # idempotent
        assert hosts.global_mesh().size() == 1
        assert distributed.make_mesh().size() == 1
        assert hosts.local_env_slice(64) == (0, 64)
        with pytest.raises(ValueError, match="need 2 ranks"):
            distributed.make_mesh(2)
        with pytest.raises(ValueError, match="need 2 ranks"):
            distributed.make_mesh_2d(1, 2)
    finally:
        torch.distributed.destroy_process_group()


def test_new_modules_leave_cuda_and_the_group_alone():
    """Importing the slice's modules initializes neither CUDA nor a
    process group (a launcher may fork after importing them), nor JAX."""
    code = (
        "import sys, torch, torch.distributed as dist\n"
        "import gym_pybullet_adrp_tpu_torch.parallel.hosts\n"
        "import gym_pybullet_adrp_tpu_torch.parallel.distributed\n"
        "import gym_pybullet_adrp_tpu_torch.scaling\n"
        "import gym_pybullet_adrp_tpu_torch._scaling_worker\n"
        "import gym_pybullet_adrp_tpu_torch.profile_ppo\n"
        "import gym_pybullet_adrp_tpu_torch.utils.profiling\n"
        "import gym_pybullet_adrp_tpu_torch.examples.learn\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not dist.is_initialized()\n"
        "assert 'jax' not in sys.modules\n"
        "print('CLEAN')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "CLEAN" in r.stdout, r.stderr[-2000:]


def test_world_of_one_equals_make_ppo():
    """make_distributed_ppo on a world of one rank is make_ppo's step bit
    for bit (the all-reduces of one rank change nothing), from the rank's
    seed."""
    rl_cfg, P_, xyz, rpy = W.hover_setup()
    cfg = ppo.PPOConfig(n_envs=8, n_steps=8, n_epochs=2, n_minibatches=2,
                        grad_accum=2)
    hosts.ensure_initialized(f"127.0.0.1:{free_port()}", 1, 0,
                             backend="gloo")
    try:
        mesh = distributed.make_mesh()
        gi, step = distributed.make_distributed_ppo(mesh, cfg, rl_cfg, P_,
                                                    xyz, rpy, device="cpu")
        ts = distributed.host_to_global(mesh, gi(7))
        specs = distributed.state_specs(ts)
        assert specs.params == specs.opt_state == distributed.REPLICATED
        assert specs.env_state == specs.last_obs == specs.rng == "dp"
        rinit, rstep, _ = ppo.make_ppo(cfg, rl_cfg, P_, xyz, rpy,
                                       device="cpu")
        rts = rinit(distributed.rank_seeds(7, 1)[0])
        for _ in range(2):
            ts, m = step(ts)
            rts, rm = rstep(rts)
        for a, b in zip(ts.params.parameters(), rts.params.parameters()):
            assert torch.equal(a, b)
        assert float(m["loss"]) == float(rm["loss"])
        assert float(m["steps"]) == cfg.batch_size
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the gradient all-reduce


def test_grouped_update_matches_shard_map(cluster, inputs):
    """grouped_update under 2 ranks with grad_accum=2 against the JAX
    shard_map update of tests/test_rl.py:208-283 on make_mesh(2)."""
    from functools import partial

    g = W.GROUPED["g"]
    w0 = _state("grouped/w/", inputs)
    params = _flax_tree(w0)
    batch = jppo.Transition(
        *[jnp.asarray(inputs[f"grouped/{k}"]) for k in
          ("obs", "action", "logp")], None, None, None)
    adv, ret = (jnp.asarray(inputs["grouped/adv"]),
                jnp.asarray(inputs["grouped/ret"]))
    loss_fn = partial(jppo.ppo_loss, FlaxAC(act_dim=4), W.CLIP, W.VF, 0.0)
    tx = optax.sgd(1.0)
    opt0 = tx.init(params)

    def local(params, opt_state, xs):
        xs = jax.tree_util.tree_map(
            lambda x: None if x is None else x.reshape((g,) + x.shape[1:]),
            xs, is_leaf=lambda v: v is None)
        (p, _), losses = jppo.grouped_update(loss_fn, tx, "dp", g, params,
                                             opt_state, xs)
        return p, losses

    rep = jax.tree_util.tree_map(lambda _: P(), params)
    rep_opt = jax.tree_util.tree_map(lambda _: P(), opt0)
    dp = jax.tree_util.tree_map(
        lambda x: None if x is None else P("dp"), (batch, adv, ret),
        is_leaf=lambda v: v is None)
    new, jl = jax.jit(jdist.shard_map(
        local, jdist.make_mesh(2), in_specs=(rep, rep_opt, dp),
        out_specs=(rep, P("dp")), check_rep=False))(params, opt0,
                                                    (batch, adv, ret))
    ref = _as_port(new, w0)
    r0, r1 = (_state("grouped/p/", o) for o in cluster.results())
    for k in ref:
        assert np.array_equal(r0[k], r1[k]), k
        np.testing.assert_allclose(r0[k], ref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    losses = np.concatenate([o["grouped/losses"] for o in cluster.results()])
    np.testing.assert_allclose(losses, np.asarray(jl), rtol=1e-5)


def test_grouped_update_one_all_reduce_per_group(cluster):
    for o in cluster.results():
        assert int(o["grouped/n_allreduce"]) == 1


def test_distributed_step_matches_shard_map(cluster, inputs):
    """make_distributed_ppo's step, each rank on its injected trajectory,
    against JAX's make_ppo_core(axis_name="dp") under shard_map with the
    shard's trajectory picked by the axis index."""
    kw = W.INJECTED
    n_envs, obs_dim = kw["n_envs"], inputs["injected/obs"].shape[-1]
    w0 = _state("injected/w/", inputs)
    traj_np = {k: jnp.asarray(inputs[f"injected/{k}"])
               for k in jppo.Transition._fields}
    last, fin = (jnp.asarray(inputs["injected/last_obs"]),
                 jnp.asarray(inputs["injected/fin"]))

    def override(ts):
        i = jax.lax.axis_index("dp")
        traj = jppo.Transition(**{k: v[i] for k, v in traj_np.items()})
        return ts._replace(last_obs=last[i]), traj, {"finished_return":
                                                     fin[i]}

    adapter = jppo.EnvAdapter(
        batched_reset=lambda key: (jnp.zeros(n_envs),
                                   jnp.zeros((n_envs, obs_dim), jnp.float32)),
        step=None, obs_dim=obs_dim, act_dim=4)
    init, train, _ = jppo.make_ppo_core(jppo.PPOConfig(**kw), adapter,
                                        axis_name="dp",
                                        rollout_override=override)
    ts = init(jax.random.PRNGKey(0))._replace(params=_flax_tree(w0))

    def local(ts):
        ts, m = train(ts)
        return ts.params, {k: jax.lax.pmean(v.astype(jnp.float32), "dp")
                           for k, v in m.items()}

    specs = jax.tree_util.tree_map(lambda _: P(), ts)
    new, jm = jax.jit(jdist.shard_map(
        local, jdist.make_mesh(2), in_specs=(specs,),
        out_specs=(jax.tree_util.tree_map(lambda _: P(), ts.params), P()),
        check_rep=False))(ts)
    ref = _as_port(new, w0)
    for o in cluster.results():
        np.testing.assert_allclose(float(o["injected/loss"]),
                                   float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(o["injected/mean_reward"]),
                                   float(jm["mean_reward"]), rtol=1e-6)
        assert float(o["injected/steps"]) == float(jm["steps"])
        _close_to_scale(_state("injected/p/", o), ref, 1e-6, "params")


def test_distributed_replicas_stay_equal(cluster):
    """The port's tests/test_rl.py:286-310: grad_accum=2, 4 minibatches,
    2 epochs, 2 steps on different shards: replicas equal bit for bit,
    one gradient all-reduce per update group."""
    r0, r1 = cluster.results()
    a, b = _state("accum/p/", r0), _state("accum/p/", r1)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    kw = W.ACCUM
    groups = kw["n_epochs"] * kw["n_minibatches"] // kw["grad_accum"]
    for o in (r0, r1):
        assert o["accum/grad_syncs"].tolist() == [groups, groups]
        assert np.isfinite(o["accum/losses"]).all()


def test_distributed_end_to_end(cluster):
    """The port's tests/test_rl.py:111-145: global_init, host_to_global,
    then rollout and update for 2 steps on 2 ranks: finite losses, the
    same on both ranks; the global batch 2 x n_envs."""
    r0, r1 = cluster.results()
    n = W.E2E["n_envs"]
    for o in (r0, r1):
        assert int(o["e2e/global_envs"]) == 2 * n
        assert int(o["e2e/local_envs"]) == n
        assert np.isfinite(o["e2e/losses"]).all()
    np.testing.assert_array_equal(r0["e2e/losses"], r1["e2e/losses"])
    for k, v in _state("e2e/p/", r0).items():
        assert np.array_equal(v, r1["e2e/p/" + k]), k


# ---------------------------------------------------------------------------
# tensor parallelism


def test_tp_specs_match_jax():
    """actor_critic_tp_specs against JAX's through convert's name map: a
    torch weight shards the other axis of the flax kernel."""
    net = ActorCritic(OBS_SMALL, 4)
    specs = distributed.actor_critic_tp_specs(net)
    jspecs = jdist.actor_critic_tp_specs(_flax_tree(
        {k: v.numpy() for k, v in net.state_dict().items()}))["params"]
    for name, (mod, leaf) in actor_critic_flax_names(net).items():
        js = jspecs[mod] if leaf is None else jspecs[mod][leaf]
        axes = [i for i, a in enumerate(js) if a == "tp"]
        if leaf == "kernel":
            axes = [1 - i for i in axes]
        assert axes == ([] if specs[name] is None else [specs[name]]), name
    assert sum(v is not None for v in specs.values()) == 6


def test_tp_forward_and_grads(cluster, inputs):
    """The tp=2 ActorCritic's forward and gradients (of sum(mean * wm) +
    sum(value * wv) + sum(log_std)) against the unsharded module's and
    flax's."""
    w0 = _state("tpfwd/w/", inputs)
    obs = inputs["tpfwd/obs"]
    wm, wv = inputs["tpfwd/wm"], inputs["tpfwd/wv"]
    net = ActorCritic(OBS_SMALL, 4)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in w0.items()})
    mean, log_std, value = net(torch.from_numpy(obs))
    loss = (torch.sum(mean * torch.from_numpy(wm))
            + torch.sum(value * torch.from_numpy(wv)) + torch.sum(log_std))
    grads = dict(zip([n for n, _ in net.named_parameters()],
                     torch.autograd.grad(loss, list(net.parameters()))))
    port = {"mean": mean.detach().numpy(), "value": value.detach().numpy()}
    port_g = {k: v.numpy() for k, v in grads.items()}

    fnet = FlaxAC(act_dim=4)

    def jloss(p):
        m, ls, v = fnet.apply(p, jnp.asarray(obs))
        return jnp.sum(m * wm) + jnp.sum(v * wv) + jnp.sum(ls)

    params = _flax_tree(w0)
    jm, _, jv = fnet.apply(params, jnp.asarray(obs))
    jg = _as_port(jax.grad(jloss)(params), w0)
    for o in cluster.results():
        for ref in (port, {"mean": np.asarray(jm), "value": np.asarray(jv)}):
            _close_to_scale({k: o["tpfwd/" + k] for k in ref}, ref, 1e-6,
                            "forward")
        for ref in (port_g, jg):
            _close_to_scale(_state("tpfwd/g/", o), ref, 1e-6, "grads")


def _pjit_check(outs, name):
    ref = _state(f"{name}/ref/", outs[0])
    np.testing.assert_allclose(outs[0][f"{name}/losses"],
                               outs[0][f"{name}/ref_losses"], rtol=1e-4)
    np.testing.assert_allclose(float(outs[0][f"{name}/mean_reward"]),
                               float(outs[0][f"{name}/ref_mean_reward"]),
                               rtol=1e-4)
    for o in outs:
        assert np.isfinite(o[f"{name}/losses"]).all()
        got = _state(f"{name}/p/", o)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=2e-6,
                                       err_msg=f"{name} {k}")


def test_pjit_tp_matches_single_process(cluster):
    """make_pjit_ppo at dp=1 x tp=2 against make_ppo in one process
    (tests/test_rl.py:313-347), 2 steps."""
    _pjit_check(cluster.results(), "pjit_tp")


def test_pjit_dp_matches_single_process(cluster):
    """make_pjit_ppo at dp=2 x tp=1: the gathered trajectory, the global
    advantage normalisation and the dp-summed gradients give the
    single-process step."""
    _pjit_check(cluster.results(), "pjit_dp")


@pytest.mark.slow
def test_pjit_2x2_matches_single_process(tmp_path):
    """dp=2 x tp=2 on 4 ranks, as the JAX 4x2 mesh case."""
    c = Cluster(4, tmp_path, {"unused": np.zeros(1)}, ("pjit_2x2",))
    _pjit_check(c.results(), "pjit_2x2")


# ---------------------------------------------------------------------------
# the sharded rollouts


@pytest.mark.parametrize("k", [0, 2], ids=["race_step", "rollout_k2"])
def test_race_rollout_sharded(cluster, k):
    """The port's tests/test_race_rowfast.py:514: 2 ranks x 128 envs x 2
    steps of getting_started 2-drone COMPETE."""
    r0, r1 = cluster.results()
    for o in (r0, r1):
        assert torch.equal(torch.from_numpy(o[f"race/{k}/local"]),
                           torch.from_numpy(o[f"race/{k}/alone"]))
        assert np.isfinite(o[f"race/{k}/total"])
    assert r0[f"race/{k}/total"] == r1[f"race/{k}/total"]
    assert r0[f"race/{k}/total"] == (r0[f"race/{k}/local"]
                                     + r1[f"race/{k}/local"])
    assert r0[f"race/{k}/local"] != r1[f"race/{k}/local"]


def test_rollout_throughput_sharded(cluster):
    r0, r1 = cluster.results()
    for o in (r0, r1):
        assert torch.equal(torch.from_numpy(o["hover_roll/local"]),
                           torch.from_numpy(o["hover_roll/alone"]))
    assert r0["hover_roll/total"] == r1["hover_roll/total"]
    assert r0["hover_roll/total"] == (r0["hover_roll/local"]
                                      + r1["hover_roll/local"])
    assert np.isfinite(r0["hover_roll/total"])


def test_make_mesh_takes_the_first_ranks(cluster):
    """make_mesh(1) on 2 ranks: JAX's devices[:n], rank 0 alone."""
    r0, r1 = cluster.results()
    assert bool(r0["mesh1/in_mesh"]) and not bool(r1["mesh1/in_mesh"])
