"""Port: the race trainer (train_race.py), the policy rollout's two paths,
the policy writer, and the entry points' device defaults, on CPU.

The K-step rollout path (kernel_chunk dividing n_steps) and the one
launch per step path draw the same numbers in the same order and run
the same step, so their trajectories and the trained params are held
equal bit for bit (the precedent of tests/test_policy_fused.py:118).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore as flax_restore

from gym_pybullet_adrp_tpu.models.policy import ActorCritic as FlaxAC
from gym_pybullet_adrp_tpu.rl import checkpoint as jck
from gym_pybullet_adrp_tpu_torch import (
    convert, eval_race, eval_race_rgb, sim, train_race,
)
from gym_pybullet_adrp_tpu_torch.control import dslpid
from gym_pybullet_adrp_tpu_torch.envs import aviary, core, fast_hover
from gym_pybullet_adrp_tpu_torch.envs import race as prace
from gym_pybullet_adrp_tpu_torch.envs import race_rl_rowfast as prow
from gym_pybullet_adrp_tpu_torch.envs import race_vector, vector
from gym_pybullet_adrp_tpu_torch.envs import rl as rlenv
from gym_pybullet_adrp_tpu_torch.models import drone, urdf
from gym_pybullet_adrp_tpu_torch.ops import render
from gym_pybullet_adrp_tpu_torch.rl import checkpoint as pck
from gym_pybullet_adrp_tpu_torch.rl import ppo

from _torch_port import REPO

SMALL = dict(config="getting_started", n_envs=128, n_steps=8, device="cpu",
             log_every=0)


def _params(net):
    return [p.detach().clone() for p in net.parameters()]


def test_train_runs_on_cpu():
    res = train_race.train(iters=2, **SMALL)
    assert len(res["metrics"]) == 2 and len(res["times"]) == 2
    for m in res["metrics"]:
        assert np.isfinite([m["loss"], m["mean_reward"]]).all(), m
        assert m["steps"] == 128 * 8
    assert set(res["times"][0]) == {"rollout", "gae", "update",
                                    "iteration"}
    for p in res["ts"].params.parameters():
        assert torch.isfinite(p).all()


def test_selfplay_compete_trains_on_cpu():
    """Two drones in COMPETE: the PPO batch is every drone of every env,
    each with its own reward; the policy runs inside the step."""
    res = train_race.train(iters=1, n_drones=2, compete=True,
                           fuse_policy=True, kernel_chunk=4,
                           **dict(SMALL, config="twogates"))
    m = res["metrics"][0]
    assert m["steps"] == 2 * 128 * 8 and np.isfinite(m["loss"])


def test_kernel_chunk_matches_per_step():
    """kernel_chunk=4 (race_rollout) and 0 (race_step per step): the same
    trajectory, metrics, carried state and trained params, bit for bit."""
    runs = {}
    for chunk in (0, 4):
        res = train_race.train(iters=1, fuse_policy=True,
                               kernel_chunk=chunk, **SMALL)
        env, ts = res["env"], res["ts"]
        # one more rollout from the trained state, through both paths
        _, override, _ = prow.make_policy_rollout(env, 8, chunk)
        ts2, traj, metrics = override(ts)
        runs[chunk] = (res["metrics"], _params(ts.params), traj, metrics,
                       ts2)
    (m0, p0, t0, r0, s0), (m1, p1, t1, r1, s1) = runs[0], runs[4]
    np.testing.assert_array_equal([list(m.values()) for m in m0],
                                  [list(m.values()) for m in m1])
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
    for f in ppo.Transition._fields:
        assert torch.equal(getattr(t0, f), getattr(t1, f)), f
    for k in r0:                        # NaN where no episode ended
        torch.testing.assert_close(r0[k], r1[k], rtol=0, atol=0,
                                   equal_nan=True)
    for f in ("last_obs", "ep_return", "ep_len"):
        assert torch.equal(getattr(s0, f), getattr(s1, f)), f


def test_save_policy_round_trips(tmp_path):
    """save_policy writes what flax and the JAX package read back equal
    to the port's params; a shipped artifact read and written back gives
    its own bytes."""
    res = train_race.train(iters=1, out=str(tmp_path / "p.msgpack"),
                           **SMALL)
    net = res["ts"].params
    data = (tmp_path / "p.msgpack").read_bytes()
    tree = flax_restore(data)
    ref = convert.flax_from_actor_critic(net)
    assert tree.keys() == ref.keys()
    for k, v in ref["params"].items():
        for kk, a in (v.items() if isinstance(v, dict) else [(None, v)]):
            b = tree["params"][k][kk] if kk else tree["params"][k]
            assert a.dtype == b.dtype and np.array_equal(a, b), (k, kk)
    fnet = FlaxAC(act_dim=4)
    template = fnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 49)))
    jparams = jck.load_policy(str(tmp_path / "p.msgpack"), template)
    for k, v in ref["params"].items():
        for kk, a in (v.items() if isinstance(v, dict) else [(None, v)]):
            b = jparams["params"][k][kk] if kk else jparams["params"][k]
            np.testing.assert_array_equal(np.asarray(b), a)
    shipped = REPO / "agents/fulltrack_policy.msgpack"
    net2 = pck.load_policy(shipped, device="cpu")
    pck.save_policy(tmp_path / "again.msgpack", net2)
    assert (tmp_path / "again.msgpack").read_bytes() == shipped.read_bytes()


def test_init_reads_shipped_policy():
    path = REPO / "agents/fulltrack_policy.msgpack"
    res = train_race.train(iters=0, init=str(path), **SMALL)
    ref = pck.load_policy(path, device="cpu")
    for a, b in zip(res["ts"].params.parameters(), ref.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flag", [
    ["--obs", "rgb"], ["--general", "--obs", "rgb"],
], ids=["obs_rgb", "general"])
def test_cli_refuses_what_is_not_ported(flag, tmp_path):
    """What the trainer refused until the pixels path was ported, ``--obs
    rgb`` alone and with ``--general``, now builds the general env and a
    ``CnnActorCritic`` of the ``--img`` frame and writes it (nothing the
    CLI offers is refused as not ported any more)."""
    out = tmp_path / "px.msgpack"
    train_race.main(["--device", "cpu", "--iters", "0", "--n_envs", "8",
                     "--img", "16x12", "--out", str(out)] + flag)
    net = pck.load_policy(out, device="cpu", img=(12, 16))
    assert net.img == (12, 16, 3)


POLICY = str(REPO / "agents/fulltrack_policy.msgpack")


@pytest.mark.parametrize("flag,match", [
    (["--league", POLICY], "league needs"),
    (["--league", POLICY, "--compete"], "league needs"),
    (["--league", POLICY, "--n_drones", "2"], "league needs"),
    (["--league", POLICY, "--general", "--compete"], "league needs"),
    (["--league", POLICY, "--compete", "--n_drones", "2",
      "--fuse_policy"], "without fuse_policy"),
    (["--prox_penalty", "0.1"], "COMPETE self-play"),
    (["--fast", "--prox_penalty", "0.1"], "COMPETE self-play"),
    (["--prox_penalty", "0.1", "--n_drones", "2"], "COMPETE self-play"),
    (["--prox_penalty", "0.1", "--compete", "--n_drones", "2",
      "--fuse_policy"], "without fuse_policy"),
], ids=["league-1drone", "league-1drone-compete", "league-compare",
        "league-general", "league-fuse", "prox-1drone", "prox-fast",
        "prox-compare", "prox-fuse"])
def test_cli_guards_raise_value_errors(flag, match):
    """The JAX script's guards on --league and --prox_penalty
    (scripts/train_race.py:153-165), as ValueErrors raised before the env
    is built."""
    with pytest.raises(ValueError, match=match):
        train_race.main(["--device", "cpu", "--iters", "0"] + flag)


@pytest.mark.parametrize("fn", [
    eval_race.evaluate, prow.make_row_env, prow.RowRaceEnv.__init__,
    pck.load_policy, convert.row_state_from_numpy, train_race.train,
    ppo.make_ppo_core, ppo.make_ppo, ppo.hover_adapter,
    fast_hover.make_step, fast_hover.ppo_adapter, fast_hover.reset_packed,
    drone.drone_params, rlenv.rl_reset, core.core_reset,
    convert.fast_hover_state_from_numpy, convert.rl_state_from_numpy,
    convert.drone_params_from_numpy, convert.pid_state_from_numpy,
    pck.restore_checkpoint, dslpid.init_state, sim.simulate,
    aviary.AviaryBase.__init__, aviary.CtrlAviary.__init__,
    aviary.VelocityAviary.__init__, aviary.BaseRLAviary.__init__,
    aviary.HoverAviary.__init__, aviary.MultiHoverAviary.__init__,
    vector.TorchVectorEnv.__init__,
    race_vector.TorchRaceVectorEnv.__init__, prace.MultiRaceAviary.__init__,
    eval_race_rgb.evaluate, ppo.rgb_hover_adapter, render.empty_scene,
    urdf.drone_params_from_urdf,
], ids=lambda fn: fn.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
