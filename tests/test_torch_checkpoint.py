"""Port: whole-train-state checkpoints (rl/checkpoint.py), on CPU.

The port's ``save_checkpoint``/``restore_checkpoint`` are the
counterparts of the JAX package's orbax pair (tests/test_checkpoint.py:
15-45). A run saved after one iteration, restored into a fresh train
state and run one more iteration equals the unbroken run bit for bit:
the policy, the Adam moments and count, every env-state tensor, the
episode bookkeeping, the metrics, and the states of both generators
(the learner's ``rng`` and the env's ``env_rng``), for ``make_ppo``
hover at 8 envs x 8 steps and the row race trainer at 128 x 8, self-play
and league included (a twogates pool of two random 2-drone policies).
Tolerance: none (``torch.equal``).
"""

import numpy as np
import pytest
import torch

from gym_pybullet_adrp_tpu_torch import train_race
from gym_pybullet_adrp_tpu_torch.envs import rl as rlenv
from gym_pybullet_adrp_tpu_torch.envs.core import AviaryConfig
from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
from gym_pybullet_adrp_tpu_torch.rl import checkpoint as ck
from gym_pybullet_adrp_tpu_torch.rl.ppo import PPOConfig, make_ppo
from gym_pybullet_adrp_tpu_torch.utils.enums import ActionType, DroneModel

from gym_pybullet_adrp_tpu_torch.models.policy import ActorCritic

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def assert_states_equal(a, b):
    la, lb = ck._flatten(a, []), ck._flatten(b, [])
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                assert torch.equal(x[k], y[k]), k
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _hover():
    rl_cfg = rlenv.RLConfig(aviary=AviaryConfig(ctrl_freq=30),
                            act_type=ActionType.ONE_D_RPM)
    cfg = PPOConfig(n_envs=8, n_steps=8, n_epochs=1, n_minibatches=2)
    return make_ppo(cfg, rl_cfg, drone_params(DroneModel.CF2X,
                                              device="cpu"),
                    np.array([[0.0, 0.0, 0.1125]]), np.zeros((1, 3)),
                    device="cpu")


def test_make_ppo_resume_equals_unbroken(tmp_path):
    init_fn, train_step, _ = _hover()
    ts = init_fn(3)
    ts, _ = train_step(ts)
    ck.save_checkpoint(tmp_path / "ck", ts, step=1)
    unbroken, m_a = train_step(ts)

    restored, step = ck.restore_checkpoint(tmp_path / "ck", init_fn(0),
                                           device="cpu")
    assert step == 1
    resumed, m_b = train_step(restored)
    assert float(m_a["loss"]) == float(m_b["loss"])
    assert_states_equal(unbroken, resumed)


ROW = dict(config="getting_started", n_envs=128, n_steps=8, device="cpu",
           log_every=0)


def league_kw(tmp_path):
    """Two drones COMPETE on twogates against a pool of two random
    policies of its 55 obs channels, with the proximity shaping."""
    paths = []
    for seed in (1, 2):
        net = ActorCritic(55, 4, generator=torch.Generator().manual_seed(
            seed))
        paths.append(str(ck.save_policy(tmp_path / f"p{seed}.msgpack",
                                        net)))
    return dict(ROW, config="twogates", n_drones=2, compete=True,
                prox_penalty=0.1, league_refresh=1, league=paths)


@pytest.mark.parametrize("case", ["row", "row-fused-policy", "league-prox"])
def test_row_trainer_resume_equals_unbroken(tmp_path, case):
    """One iteration, save, a second iteration (the unbroken run); a fresh
    ``train(iters=0)`` state restored and stepped once equals it bit for
    bit, the env's generator (``TrainState.env_rng``, the one
    ``_row_adapter`` hands the row env) included."""
    kw = {"row": ROW, "row-fused-policy": dict(ROW, fuse_policy=True,
                                               kernel_chunk=4),
          "league-prox": None}[case] or league_kw(tmp_path)

    def refresh(ts):        # what train() does after an iteration
        if "league" not in kw:
            return ts
        return ts._replace(env_state=ts.env_state._replace(
            pool=train_race.refresh_pool(ts.env_state.pool, ts.params)))

    first = train_race.train(iters=1, **kw)
    ck.save_checkpoint(tmp_path / "ck", first["ts"], step=1)
    whole, m_whole = first["train_step"](first["ts"])
    whole = refresh(whole)
    fresh = train_race.train(iters=0, **kw)
    assert fresh["ts"].env_rng is fresh["env"].generator
    ts, step = ck.restore_checkpoint(tmp_path / "ck", fresh["ts"],
                                     device="cpu")
    assert step == 1 and ts.env_rng is fresh["env"].generator
    ts, m = fresh["train_step"](ts)
    # NaN where no episode ended, equal as NaN
    np.testing.assert_equal({k: float(v) for k, v in m.items()},
                            {k: float(v) for k, v in m_whole.items()})
    assert_states_equal(whole, refresh(ts))


def test_keep_prunes_and_latest_restores(tmp_path):
    init_fn, _, _ = _hover()
    ts = init_fn(1)
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(tmp_path / "none", ts, device="cpu")
    for step in (1, 2, 5, 7):
        with torch.no_grad():
            ts.params.log_std.fill_(float(step))
        ck.save_checkpoint(tmp_path, ts._replace(
            opt_state=ts.opt_state._replace(count=step)), step, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["5", "7"]
    for step in (None, 5):
        got, s = ck.restore_checkpoint(tmp_path, init_fn(2), step=step,
                                       device="cpu")
        want = 7 if step is None else 5
        assert s == want and got.opt_state.count == want
        assert torch.equal(got.params.log_std, torch.full((1,), want * 1.0))
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(tmp_path, ts, step=2, device="cpu")
    other = rlenv.RLConfig(aviary=AviaryConfig(ctrl_freq=30))
    bad = ts._replace(last_obs=torch.zeros(8, other.obs_size))
    with pytest.raises(ValueError, match="does not fit"):
        ck.restore_checkpoint(tmp_path, bad, device="cpu")
