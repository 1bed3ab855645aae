"""Port: the plain versions of the hover kernels (K1, K2, K7, K8) and of
the op-cost chains (K6) against the JAX package on CPU, and the hover
env and its PPO paths on the port's CPU path.

Tolerances (XLA on CPU contracts multiply-adds into FMAs; the port rounds
every op separately):
  K1 vs the Pallas kernel (interpret mode) and vs the port's dynamics:
    pos/quat/vel atol 2e-5, body rates 2e-4 (tests/test_pallas.py:31).
  K2/K7/K8 (injected actions) vs a loop of pallas_step.rollout_step_math:
    state atol 2e-5, acc 1e-4, episode step counts equal; lanes whose
    done flag flips between the two roundings are masked (at most 2%).
  K6 vs vpu_calibrate._kernel (interpret mode), iters 2, rows 8: rtol 1e-5
    (the log chain ends in NaN on both sides).
  fast_hover.make_step vs JAX (interpret mode), 16 steps: state and obs
    atol 2e-5 (rates 2e-4), reward atol 1e-5, done equal.
  eval_rollout of make_ppo (hover_adapter) and of make_ppo_core over
    fast_hover.ppo_adapter vs JAX, the same flax weights, 40 steps: the
    deterministic returns atol 5e-5 (measured at most 2.3e-5).
"""

import importlib.util
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from gym_pybullet_adrp_tpu.envs import core as jcore
from gym_pybullet_adrp_tpu.envs import fast_hover as jfast
from gym_pybullet_adrp_tpu.envs import rl as jrl
from gym_pybullet_adrp_tpu.models import drone as jdrone
from gym_pybullet_adrp_tpu.models.policy import ActorCritic as FlaxAC
from gym_pybullet_adrp_tpu.ops import pallas_step as jps
from gym_pybullet_adrp_tpu.ops import quat as jquat
from gym_pybullet_adrp_tpu.rl import ppo as jppo
from gym_pybullet_adrp_tpu.utils import enums as jenums
from gym_pybullet_adrp_tpu_torch import convert, op_calibrate
from gym_pybullet_adrp_tpu_torch.convert import fast_hover_state_from_numpy
from gym_pybullet_adrp_tpu_torch.envs import core, fast_hover, rl as rlenv
from gym_pybullet_adrp_tpu_torch.models import drone
from gym_pybullet_adrp_tpu_torch.ops import dynamics, hover_step as hs
from gym_pybullet_adrp_tpu_torch.ops import hover_variants as hv
from gym_pybullet_adrp_tpu_torch.rl import ppo
from gym_pybullet_adrp_tpu_torch.utils.enums import (
    ActionType, DroneModel, Physics,
)

from _torch_port import REPO

F32 = np.float32
JP = jdrone.drone_params(jenums.DroneModel.CF2X, dtype=jnp.float32)
P = drone.drone_params(DroneModel.CF2X, device="cpu")
TOLS = (("pos", 2e-5), ("quat", 2e-5), ("vel", 2e-5), ("omega", 2e-4))
# eval returns: sums of 40 float32 rewards of about 1.4 to 2.9 (measured
# 2.3e-5 at a return of 50.6, a few ulps of it)
EVAL_ATOL = 5e-5


def _k1_inputs(B=256, seed=1):
    """tests/test_pallas.py:31's distribution, plus 4 envs in ground
    contact (z 0.02, falling, motors off)."""
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(-1, 1, size=(B, 3)) + [0, 0, 1.5]).astype(F32)
    rpy = rng.uniform(-0.3, 0.3, size=(B, 3)).astype(F32)
    quat = np.array(jquat.from_euler_xyz(jnp.asarray(rpy)), dtype=F32)
    vel = rng.uniform(-1, 1, size=(B, 3)).astype(F32)
    om = rng.uniform(-2, 2, size=(B, 3)).astype(F32)
    rpm = (rng.uniform(0.9, 1.1, size=(B, 4))
           * float(JP.hover_rpm)).astype(F32)
    pos[:4] = [0.0, 0.0, 0.02]
    quat[:4] = [0.0, 0.0, 0.0, 1.0]
    vel[:4] = [0.0, 0.0, -1.0]
    om[:4] = 0.0
    rpm[:4] = 0.0
    return pos, quat, vel, om, rpm


def _close(got, ref):
    for (name, tol), g, r in zip(TOLS, got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), atol=tol,
                                   err_msg=name)


def test_pack_unpack_roundtrip():
    x = [torch.from_numpy(a) for a in _k1_inputs()[:4]]
    packed = hs.pack_state(*x)
    assert packed.shape == (13, 2, 128)
    for a, b in zip(hs.unpack_state(packed), x):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jps.pack_state(*[jnp.asarray(a.numpy())
                                                    for a in x])))


def test_k1_plain_matches_pallas_interpret():
    pos, quat, vel, om, rpm = _k1_inputs()
    ref = jps.ctrl_step(JP, *(jnp.asarray(a) for a in (pos, quat, vel, om,
                                                       rpm)),
                        8, 1 / 240, interpret=True)
    before = hs.ctrl_step_packed.launches
    got = hs.ctrl_step(P, *(torch.from_numpy(a) for a in (pos, quat, vel, om,
                                                          rpm)), 8, 1 / 240)
    assert hs.ctrl_step_packed.launches == before   # CPU: the plain version
    _close(got, ref)
    # the ground-contact envs rest at the collision cylinder's half height
    np.testing.assert_allclose(got[0][:4, 2].numpy(), 0.0125, atol=1e-6)
    assert (got[2][:4, 2] >= 0).all()


def test_k1_plain_matches_port_dynamics():
    pos, quat, vel, om, rpm = (torch.from_numpy(a) for a in _k1_inputs())
    got = hs.ctrl_step(P, pos, quat, vel, om, rpm, 8, 1 / 240)
    ref, _ = dynamics.ctrl_step(
        P, dynamics.PhysState(pos[:, None], quat[:, None], vel[:, None],
                              om[:, None]),
        rpm[:, None], rpm[:, None], 1 / 240, 8, DroneModel.CF2X, Physics.PYB)
    _close(got, [x[:, 0] for x in ref])
    assert hs.supports(P, DroneModel.CF2X, Physics.PYB, 256, torch.float32)
    assert not hs.supports(P, DroneModel.CF2P, Physics.PYB, 256,
                           torch.float32)


def _rollout_refs(n_steps, smallangle, seed=3):
    """Injected actions (n_steps, 4, 1, 128) in [-1, 1], the JAX loop of
    rollout_step_math and its per-step (state, steps, acc)."""
    rng = np.random.default_rng(seed)
    packed = np.zeros((13, 1, 128), F32)
    packed[2] = 0.1125
    packed[6] = 1.0
    acts = rng.uniform(-1, 1, size=(n_steps, 4, 1, 128)).astype(F32)
    step = jax.jit(partial(jps.rollout_step_math, JP),
                   static_argnames=("smallangle",))
    st, steps = jnp.asarray(packed), jnp.zeros((1, 128), jnp.int32)
    acc = jnp.zeros((1, 128), jnp.float32)
    refs = []
    for k in range(n_steps):
        st, steps, acc, _ = step(st, jnp.asarray(acts[k]), steps, acc,
                                 smallangle=smallangle)
        refs.append((np.asarray(st), np.asarray(steps), np.asarray(acc)))
    return packed, acts, refs


def _check_rollout(packed, acts, refs, final, smallangle):
    """The port's rollout_step_math loop against the JAX one, step by step
    on lanes whose episode counts agree so far; then ``final`` (state,
    acc) against the port's loop, bit for bit."""
    st = torch.from_numpy(packed)
    steps = torch.zeros((1, 128), dtype=torch.int32)
    acc = torch.zeros((1, 128))
    stable = np.ones((1, 128), bool)
    for k, (rst, rsteps, racc) in enumerate(refs):
        st, steps, acc, _ = hs.rollout_step_math(
            P, st, torch.from_numpy(acts[k]), steps, acc,
            smallangle=smallangle)
        stable &= steps.numpy() == rsteps
        np.testing.assert_allclose(st.numpy()[:, stable], rst[:, stable],
                                   atol=2e-5, err_msg=f"step {k}")
        np.testing.assert_allclose(acc.numpy()[stable], racc[stable],
                                   atol=1e-4)
    assert stable.mean() >= 0.98
    assert (steps.numpy() < len(refs)).any()   # some episodes ended
    assert torch.equal(final[0], st) and torch.equal(final[1], acc)


@pytest.mark.parametrize("smallangle", [True, False],
                         ids=["smallangle", "exact"])
def test_k2_plain_matches_rollout_step_math(smallangle):
    packed, acts, refs = _rollout_refs(32, smallangle)
    final = hs.hover_rollout(P, torch.from_numpy(packed), 0, 32,
                             smallangle=smallangle,
                             actions=torch.from_numpy(acts))
    _check_rollout(packed, acts, refs, final, smallangle)


@pytest.mark.parametrize("variant", ["v2", "v2_exact_sqrt", "v3"])
def test_k7_k8_plain_match_rollout_step_math(variant):
    """v2 runs the exact integrator, v3 the small-angle one. v2's
    sqrt-free termination test differs from rollout_step_math's exact-mode
    test only for |e| < 1e-4, which no lane reaches here."""
    smallangle = variant == "v3"
    packed, acts, refs = _rollout_refs(32, smallangle, seed=4)
    a = torch.from_numpy(acts)
    st = torch.from_numpy(packed)
    if variant == "v3":
        final = hv.hover_rollout_v3(P, st, 0, 32, actions=a)
        k2 = hs.hover_rollout(P, st, 0, 32, actions=a)
    else:
        final = hv.hover_rollout_v2(P, st, 0, 32, actions=a,
                                    exact_sqrt=variant == "v2_exact_sqrt")
        k2 = hs.hover_rollout(P, st, 0, 32, smallangle=False, actions=a)
    _check_rollout(packed, acts, refs, final, smallangle)
    assert all(torch.equal(x, y) for x, y in zip(final, k2))


def test_k2_random_mode():
    """The in-kernel draws: Philox4x32-10 (Random123's known-answer
    vectors), actions in [-act_scale, act_scale), a seed gives one stream,
    two seeds two."""
    t = lambda *v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    kat = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in kat:
        got = hs.philox4x32(*(t(c) for c in ctr), *key)
        assert tuple(int(g) for g in got) == want
    a = hs.uniform_actions(7, 3, (2, 128), 0.05, "cpu")
    assert a.shape == (4, 2, 128) and a.dtype == torch.float32
    assert float(a.min()) >= -0.05 and float(a.max()) < 0.05
    assert abs(float(a.mean())) < 0.005
    st = fast_hover.reset_packed(np.array([0.0, 0.0, 0.1125]), 128,
                                 device="cpu").packed
    r1 = hs.hover_rollout(P, st, 7, 16, count_resets=True)
    r2 = hs.hover_rollout(P, st, 7, 16, count_resets=True)
    r3 = hs.hover_rollout(P, st, 8, 16, count_resets=True)
    assert all(torch.equal(x, y) for x, y in zip(r1, r2))
    assert not torch.equal(r1[0], r3[0])
    assert torch.isfinite(r1[0]).all() and r1[2].shape == (1, 128)


def _vpu_calibrate():
    spec = importlib.util.spec_from_file_location(
        "vpu_calibrate", REPO / "scripts" / "vpu_calibrate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("op", list(op_calibrate.OPS))
def test_k6_plain_matches_pallas_interpret(op):
    vc = _vpu_calibrate()
    assert list(vc.OPS) == list(op_calibrate.OPS)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.3, 1.2, size=(8, 128)).astype(F32)
    ref = pl.pallas_call(
        partial(vc._kernel, op=op, iters=2),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True,
    )(jnp.asarray(x))
    got = op_calibrate.op_chain(op, torch.from_numpy(x), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               equal_nan=True)
    assert np.isnan(got.numpy()).all() == (op == "log")


def test_fast_hover_make_step_matches_jax():
    B, n = 128, 16
    rng = np.random.default_rng(2)
    jstep = jax.jit(jfast.make_step(JP, B, interpret=True))
    step = fast_hover.make_step(P, B, device="cpu")
    jst = jfast.reset_packed(np.array([0.0, 0.0, 0.1125]), B)
    # start mid-flight: tilted, moving, two envs at the bounds
    _, quat, vel, om, _ = _k1_inputs(B, seed=5)
    packed = np.array(jst.packed)
    packed[2] = 1.0
    packed[3:7] = quat.T.reshape(4, 1, 128)
    packed[7:10] = vel.T.reshape(3, 1, 128) * 0.5
    packed[10:13] = om.T.reshape(3, 1, 128)
    packed[0, 0, :2] = 1.49
    jst = jst._replace(packed=jnp.asarray(packed))
    st = fast_hover_state_from_numpy(packed, np.asarray(jst.step_count),
                                     device="cpu")
    n_done = 0
    for i in range(n):
        a = rng.uniform(-1, 1, size=(4, 1, 128)).astype(F32)
        jst, (jobs, jrew, jdone) = jstep(jst, jnp.asarray(a))
        st, (obs, rew, done) = step(st, torch.from_numpy(a))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone),
                                      err_msg=f"step {i}")
        for rows, tol in (([0, 1, 2, 3, 4, 5, 6, 7, 8], 2e-5),
                          ([9, 10, 11], 2e-4)):
            np.testing.assert_allclose(obs.numpy()[rows],
                                       np.asarray(jobs)[rows], atol=tol)
        np.testing.assert_allclose(st.packed.numpy()[:10],
                                   np.asarray(jst.packed)[:10], atol=2e-5)
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-5)
        np.testing.assert_array_equal(st.step_count.numpy(),
                                      np.asarray(jst.step_count))
        n_done += int(done.sum())
    assert n_done >= 2


def test_ppo_adapter_iteration_on_cpu():
    cfg = ppo.PPOConfig(n_envs=128, n_steps=8, n_epochs=2, n_minibatches=2)
    adapter = fast_hover.ppo_adapter(P, 128, device="cpu")
    init, train_step, eval_rollout = ppo.make_ppo_core(cfg, adapter,
                                                       device="cpu")
    ts = init(0)
    times = {}
    ts, m = train_step(ts, times=times)
    assert np.isfinite(float(m["loss"])) and m["steps"] == 128 * 8
    assert set(times) == {"rollout", "gae", "update"}
    ret = eval_rollout(ts.params, 8)
    assert ret.shape == (128,) and torch.isfinite(ret).all()


def test_make_ppo_iteration_on_cpu():
    rl_cfg = rlenv.RLConfig(aviary=core.AviaryConfig(ctrl_freq=30),
                            act_type=ActionType.ONE_D_RPM)
    cfg = ppo.PPOConfig(n_envs=16, n_steps=8, n_epochs=2, n_minibatches=2)
    init, train_step, eval_rollout = ppo.make_ppo(
        cfg, rl_cfg, P, np.array([[0.0, 0.0, 0.1125]]), np.zeros((1, 3)),
        device="cpu")
    ts = init(0)
    assert ts.last_obs.shape == (16, rl_cfg.obs_size)
    ts, m = train_step(ts)
    assert np.isfinite(float(m["loss"]))
    ret = eval_rollout(ts.params, 4)
    assert ret.shape == (1,) and torch.isfinite(ret).all()
    obs = torch.zeros((3, 2, 5))
    assert ppo.flatten_obs(rl_cfg, obs).shape == (3, 10)


def _flax_policy(obs_dim, act_dim, seed=1, mean_scale=40.0):
    """A flax ActorCritic's params (numpy) and the port's net with the
    same weights. The mean head's init scale (0.01) leaves the action near
    0; scaled up, the policy steers the drones off the hover point."""
    import flax

    params = FlaxAC(act_dim=act_dim).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim), jnp.float32))
    params = flax.core.unfreeze(jax.tree_util.tree_map(
        lambda x: np.array(x, dtype=F32), params))
    head = params["params"]["Dense_2"]
    head["kernel"] = head["kernel"] * F32(mean_scale)
    return params, convert.actor_critic_from_flax(params)


@torch.no_grad()
def _first_done(adapter, net, n_steps):
    """The step at which env 0's first episode ends under the mean action
    on the port's side, or None (no autograd: the kernel routes refuse
    it)."""
    state, obs = adapter.batched_reset()
    for k in range(n_steps):
        mean, _, _ = net(obs.to(torch.float32))
        state, obs, _, done = adapter.step(state, torch.clamp(mean, -1, 1))
        if bool(done[0]):
            return k
    return None


@pytest.mark.parametrize("task,act,n_drones", [
    ("hover", ActionType.ONE_D_RPM, 1), ("hover", ActionType.RPM, 1),
    ("multihover", ActionType.RPM, 2)],
    ids=["hover-one_d_rpm", "hover-rpm", "multihover-rpm"])
def test_make_ppo_eval_rollout_matches_jax(task, act, n_drones):
    """make_ppo's eval_rollout (hover_adapter: the flattened per-drone obs,
    the action reshaped per drone) against the JAX package's, 40 steps.
    Under RPM actions the policy tilts the drones out of bounds and the
    first episode ends inside the window (steps 36 and 28), so the mask
    that keeps the first episode's return is held too; ONE_D_RPM only
    climbs and runs the whole window."""
    n_steps = 40
    init = np.array([[0.0, 0.0, 0.1125], [0.3, 0.3, 0.1125]])[:n_drones]
    rpys = np.zeros((n_drones, 3))
    aviary = dict(ctrl_freq=30, num_drones=n_drones)
    rl_cfg = rlenv.RLConfig(aviary=core.AviaryConfig(**aviary),
                            act_type=act, task=task)
    jrl_cfg = jrl.RLConfig(aviary=jcore.AviaryConfig(**aviary),
                           act_type=jenums.ActionType[act.name], task=task)
    params, net = _flax_policy(n_drones * rl_cfg.obs_size,
                               n_drones * rl_cfg.act_size)
    jcfg = jppo.PPOConfig(n_envs=4, n_steps=8)
    cfg = ppo.PPOConfig(n_envs=4, n_steps=8)
    _, _, jeval = jppo.make_ppo(jcfg, jrl_cfg, JP, init, rpys)
    _, _, evaluate = ppo.make_ppo(cfg, rl_cfg, P, init, rpys, device="cpu")
    ref = np.asarray(jeval(params, jax.random.PRNGKey(0), n_steps))
    got = evaluate(net, n_steps).numpy()
    assert got.shape == ref.shape == (1,)
    np.testing.assert_allclose(got, ref, atol=EVAL_ATOL)
    done_at = _first_done(ppo.hover_adapter(cfg, rl_cfg, P, init, rpys,
                                            device="cpu"), net, n_steps)
    assert (done_at is None) == (act == ActionType.ONE_D_RPM)


def test_ppo_adapter_eval_rollout_matches_jax():
    """make_ppo_core's eval_rollout over fast_hover.ppo_adapter (K1 in
    interpret mode on the JAX side) against the JAX package's, 40 steps;
    the first episode ends at step 15, inside the window."""
    B, n_steps = 128, 40
    params, net = _flax_policy(12, 4, seed=2)
    jcfg = jppo.PPOConfig(n_envs=B, n_steps=8)
    cfg = ppo.PPOConfig(n_envs=B, n_steps=8)
    _, _, jeval = jppo.make_ppo_core(
        jcfg, jfast.ppo_adapter(JP, B, interpret=True))
    adapter = fast_hover.ppo_adapter(P, B, device="cpu")
    _, _, evaluate = ppo.make_ppo_core(cfg, adapter, device="cpu")
    ref = np.asarray(jeval(params, jax.random.PRNGKey(0), n_steps))
    got = evaluate(net, n_steps).numpy()
    assert got.shape == ref.shape == (B,)
    np.testing.assert_allclose(got, ref, atol=EVAL_ATOL)
    assert _first_done(adapter, net, n_steps) is not None


def test_folded_consts_give_the_same_result():
    """A loop folds the constants once (``consts=``); the wrappers give
    what they give when they fold them themselves."""
    pos, quat, vel, om, rpm = (torch.from_numpy(a) for a in _k1_inputs())
    packed = hs.pack_state(pos, quat, vel, om)
    rpm = rpm.T.reshape(4, 2, 128).contiguous()
    c1 = hs.hover_consts(P, 8, 1 / 240)
    assert torch.equal(hs.ctrl_step_packed(P, packed, rpm, 8, 1 / 240),
                       hs.ctrl_step_packed(P, packed, rpm, 8, 1 / 240,
                                           consts=c1))
    st = fast_hover.reset_packed([0.0, 0.0, 0.1125], 128, device="cpu").packed
    c = hs.hover_consts(P)
    for fn in (hs.hover_rollout, hv.hover_rollout_v2, hv.hover_rollout_v3):
        a, b = fn(P, st, 5, 8), fn(P, st, 5, 8, consts=c)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    ref = hv.hover_rollout_v2_plain(P, st, 5, 8, exact_sqrt=True)
    assert all(torch.equal(x, y) for x, y in zip(
        ref, hs.hover_rollout_plain(P, st, 5, 8, smallangle=False)))
    assert all(torch.equal(x, y) for x, y in zip(
        hv.hover_rollout_v3_plain(P, st, 5, 8),
        hs.hover_rollout_plain(P, st, 5, 8)))


def test_hover_wrappers_refuse_other_devices(monkeypatch):
    st = torch.zeros((13, 1, 128), device="meta")
    rpm = torch.zeros((4, 1, 128), device="meta")
    with pytest.raises(ValueError):
        hs.ctrl_step_packed(P, st, rpm, 8, 1 / 240)
    for fn in (partial(hs.hover_rollout, P), partial(hv.hover_rollout_v2, P),
               partial(hv.hover_rollout_v3, P)):
        with pytest.raises(ValueError):
            fn(st, 0, 4)
    with pytest.raises(ValueError):
        op_calibrate.op_chain("sin", torch.zeros((8, 128), device="meta"), 2)
    # the calibration measures the card and refuses to time the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        op_calibrate.chain_time("fma", 1, 8)


@pytest.mark.parametrize("n_sm", [132, 114, 8])
def test_lane_count_rule(n_sm):
    """L is 4 while B * 4 / 32 warps fit one per SM sub-partition (four per
    SM), else 1; it never rises with B, and each L it picks is built."""
    last = 4
    for B in range(128, 131072 + 1, 128):
        L = hs.lane_count(B, n_sm)
        assert L in hs.ROLLOUT_LANES and L <= last
        assert L == (4 if B // 32 * 4 <= 4 * n_sm else 1)
        last = L
    if n_sm == 132:   # an H100 SXM
        assert [hs.lane_count(B) for B in (1024, 2048, 4096, 4224, 4352,
                                           8192, 16384, 65536)] == \
            [4, 4, 4, 4, 1, 1, 1, 1]


def test_launch_args_pack_as_the_c_structs():
    """The packed arguments of the hover entry points have the size and
    field offsets of ``struct RolloutArgs`` (csrc/hover_rollout.cu) and
    ``struct StepArgs`` (csrc/hover_step.cu) on a 64-bit host: pointers
    first, then B, then the 32-bit fields."""
    assert hs._ROLLOUT_ARGS.size == 88 and hs._STEP_ARGS.size == 56
    buf = hs._ROLLOUT_ARGS.pack(1, 0, 3, 4, 0, 6, 7, 2 ** 40, 64,
                                0xFFFFFFFF, 1, 0, 4, 128)
    assert np.frombuffer(buf[:64], dtype="<u8").tolist() == \
        [1, 0, 3, 4, 0, 6, 7, 2 ** 40]
    assert np.frombuffer(buf[64:], dtype="<u4").tolist() == \
        [64, 0xFFFFFFFF, 1, 0, 4, 128]
    buf = hs._STEP_ARGS.pack(1, 2, 3, 4, 5, 4096, 128)
    assert np.frombuffer(buf[:48], dtype="<u8").tolist() == \
        [1, 2, 3, 4, 5, 4096]
    assert np.frombuffer(buf[48:], dtype="<u4").tolist() == [128, 0]


def test_folded_consts_carry_their_struct():
    """hover_consts folds its ctypes struct once: equal field by field to a
    fresh struct of the same values, read-only, and each call has its
    own."""
    c = hs.hover_consts(P, 8, 1 / 240)
    fresh = hs.consts_struct(dict(c))
    assert hs.consts_struct(c) is c.struct
    assert hs.consts_struct(dict(c)) is not c.struct
    for name, _ in hs.HoverConsts._fields_:
        assert getattr(c.struct, name) == getattr(fresh, name), name
    assert bytes(c.struct) == bytes(fresh)
    with pytest.raises(TypeError):
        c["dt"] = 0.5
    with pytest.raises(TypeError):
        c.update(dt=0.5)
    other = hs.hover_consts(P, 4, 1 / 120)
    assert other.struct is not c.struct
    assert other.struct.n_substeps == 4 and c.struct.n_substeps == 8
    assert other.struct.dt == pytest.approx(1 / 120, rel=1e-6)
    assert bytes(hs.hover_consts(P, 8, 1 / 240).struct) == bytes(c.struct)
