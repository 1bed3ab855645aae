"""Port: the public race surfaces (envs/race.MultiRaceAviary and
envs/race_vector.TorchRaceVectorEnv) against the JAX package on CPU.

* ``MultiRaceAviary`` against the JAX class (2 drones, getting_started):
  reset obs equal to 1e-6; then per control step from the JAX class's
  state (copied into the port's, ``to_port``), the same commands (the
  planner's TAKEOFF, holds, FULLSTATE tuples, ndarray targets) through
  both classes: on gating-stable envs (``mell_stable``) the obs at
  ``check_blocks``' tolerances (positions and velocities atol 1e-5,
  angles and rates 1e-3, track channels and flags equal, opponent
  channels 1e-3), reward, flags and ``task_completed`` equal; on every
  step positions within 2 cm.
* ``TorchRaceVectorEnv``, as tests/test_race_vector.py:18-170: the API,
  seeded determinism (bit for bit) and the randomization ladder; the
  fused backend (the race_step kernel's plain version here) against the
  general env in closed loop on the deterministic getting_started track
  (obs and rewards atol 5e-3, flags and gates equal, as the JAX test);
  the pre-autoreset telemetry of done rows equal across the backends;
  the guards; one ``.cpu()`` download and no scalar read a step.

The agents and sim.py: tests/test_torch_agents.py.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gym_pybullet_adrp_tpu.envs.race import MultiRaceAviary as JRace
from gym_pybullet_adrp_tpu.utils import enums as jenums
from gym_pybullet_adrp_tpu_torch.envs.race import MultiRaceAviary
from gym_pybullet_adrp_tpu_torch.envs.race_vector import TorchRaceVectorEnv
from gym_pybullet_adrp_tpu_torch.utils.config import load_config
from gym_pybullet_adrp_tpu_torch.utils.enums import Command, RaceMode

from _torch_port import (  # noqa: F401
    assert_race_obs, mell_stable, one_thread, to_port,
)

pytestmark = pytest.mark.usefixtures("one_thread")


# ---- MultiRaceAviary ------------------------------------------------------

def _commands(i):
    if i == 0:
        return [(Command.TAKEOFF, [0.4, 1.0]), (Command.TAKEOFF, [0.3, 1.2])]
    if i < 4:
        return [(Command.NONE, []), (Command.NONE, [])]
    if i < 7:
        return [(Command.FULLSTATE, [np.array([0.9, 0.8, 0.4]), np.zeros(3),
                                     np.zeros(3), 0.1, np.zeros(3), i / 25]),
                (Command.NOTIFY, [i / 25])]
    return np.array([[0.8, 0.7, 0.5, 0.0], [1.2, 1.0, 0.4, 0.2]])


def _jcmd(cmds):
    if isinstance(cmds, np.ndarray):
        return cmds
    return [(jenums.Command(int(c)), a) for c, a in cmds]


def test_multi_race_aviary_matches_jax():
    jenv = JRace("getting_started", num_drones=2)
    penv = MultiRaceAviary("getting_started", num_drones=2, device="cpu")
    for k in ("NUM_DRONES", "CTRL_FREQ", "PYB_FREQ", "PYB_STEPS_PER_CTRL",
              "CTRL_TIMESTEP", "num_gates", "EPISODE_LEN_SEC"):
        assert getattr(penv, k) == getattr(jenv, k), k
    for sp in ("action_space", "observation_space"):
        a, b = getattr(penv, sp), getattr(jenv, sp)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)
    jo, ji = jenv.reset(seed=0)
    po, pi = penv.reset(seed=0)
    assert pi == ji and po.dtype == jo.dtype
    np.testing.assert_allclose(po, jo, atol=1e-6)
    G, O = penv.spec_.num_gates, penv.spec_.num_obstacles
    n_stable = 0
    for i in range(26):
        penv._state = to_port(
            jax.tree_util.tree_map(lambda x: np.asarray(x)[None],
                                   jenv._state), penv._state)
        stable = bool(mell_stable(penv._state.mell)[0])
        cmds = _commands(i)
        jr = jenv.step(_jcmd(cmds))
        pr = penv.step(cmds)
        assert pr[0].shape == jr[0].shape and pr[0].dtype == jr[0].dtype
        assert np.abs(pr[0][:, :3] - jr[0][:, :3]).max() <= 2e-2, i
        if stable:
            n_stable += 1
            assert_race_obs(pr[0], jr[0], G, O)
            assert pr[1:] == jr[1:], i
            np.testing.assert_array_equal(penv.current_gate,
                                          jenv.current_gate)
            np.testing.assert_array_equal(penv.drones_finished,
                                          jenv.drones_finished)
            np.testing.assert_array_equal(penv.drones_eliminated,
                                          jenv.drones_eliminated)
        assert penv.step_counter == jenv.step_counter
    # the gating of this flight's ticks is rounding-independent on steps
    # 2 and 13-24
    assert n_stable >= 8


def test_multi_race_aviary_seeds_and_camera():
    from gym_pybullet_adrp_tpu_torch.utils.enums import ObservationType

    env = MultiRaceAviary("level2", num_drones=2, device="cpu")
    a = env.reset()[0]
    np.testing.assert_array_equal(a, env.reset()[0])   # reseed_on_reset
    assert not np.array_equal(a, env.reset(seed=5)[0])
    lvl3 = MultiRaceAviary("level3", num_drones=2, device="cpu")
    assert not np.array_equal(lvl3.reset()[0], lvl3.reset()[0])
    rgb = MultiRaceAviary("getting_started", obs=ObservationType.RGB,
                          device="cpu")
    assert rgb.reset()[0].shape == (2, 48, 64, 4)


# ---- TorchRaceVectorEnv -----------------------------------------------------

class ScalarReads(TorchDispatchMode):
    """Counts tensor-to-Python scalar reads (a device sync on the card)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_api_seeded_determinism_and_one_download(monkeypatch):
    B = 128
    venv = TorchRaceVectorEnv(B, config="twogates", device="cpu")
    assert venv.fused_backend
    assert venv.single_action_space.shape == (4,)
    assert venv.action_space.shape == (B, 4)
    assert venv.metadata["autoreset_mode"].value == "SameStep"
    obs, _ = venv.reset(seed=5)
    assert obs.shape == (B,) + venv.single_observation_space.shape
    acts = np.random.default_rng(0).uniform(-1, 1, (3, B, 4)).astype(
        np.float32)
    first = []
    for a in acts:
        o, r, te, tr, info = venv.step(a)
        first.append((o, r, te, tr))
        for k in ("current_gate", "eliminated", "finished", "ep_steps",
                  "task_completed"):
            assert np.asarray(info[k]).shape[0] == B
    venv.reset(seed=5)
    for i, a in enumerate(acts):
        for x, y in zip(venv.step(a)[:4], first[i]):
            np.testing.assert_array_equal(x, y, err_msg=f"step {i}")
    venv.reset(seed=9)
    downloads = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t, *a, **k: downloads.append(1) or cpu(t))
    with ScalarReads() as reads:
        for a in acts:
            *_, info = venv.step(a)
    assert len(downloads) == len(acts) and reads.n == 0
    assert info["ep_steps"].max() == len(acts) and info["ep_steps"].min() >= 1


def test_seed_randomization_ladder():
    venv = TorchRaceVectorEnv(128, config="level2", device="cpu")
    o1, _ = venv.reset(seed=1)
    o1b, _ = venv.reset(seed=1)
    o2, _ = venv.reset(seed=2)
    np.testing.assert_array_equal(o1, o1b)
    assert not np.allclose(o1, o2) and not np.allclose(o1[0], o1[1])


def test_fused_backend_matches_general_and_done_telemetry():
    """Closed loop on getting_started (deterministic), the episode cut to
    4 control steps so that every env is done on step 4: the fused
    backend against the general env, and the done rows' telemetry equal
    and pre-autoreset (ep_steps 4), then 1 on the next step."""
    B = 128
    cfg = load_config("getting_started")
    cfg.episode_len_sec = 4.0 / cfg.ctrl_freq
    vf = TorchRaceVectorEnv(B, config=cfg, backend="fused", device="cpu")
    vg = TorchRaceVectorEnv(B, config=cfg, backend="general", device="cpu")
    assert vf.fused_backend and not vg.fused_backend
    of, _ = vf.reset(seed=3)
    og, _ = vg.reset(seed=3)
    np.testing.assert_allclose(of, og, atol=1e-5)
    rng = np.random.default_rng(1)
    saw_done = False
    for i in range(5):
        a = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
        of, rf, tef, trf, inf_f = vf.step(a)
        og, rg, teg, trg, inf_g = vg.step(a)
        np.testing.assert_allclose(of, og, atol=5e-3, err_msg=f"obs {i}")
        np.testing.assert_allclose(rf, rg, atol=5e-3, err_msg=f"rew {i}")
        np.testing.assert_array_equal(tef, teg)
        np.testing.assert_array_equal(trf, trg)
        for k in ("current_gate", "eliminated", "finished", "ep_steps",
                  "task_completed"):
            np.testing.assert_array_equal(inf_f[k], inf_g[k],
                                          err_msg=f"step {i} {k}")
        if i == 3:
            # the episodes that ran the whole cut length end here, and
            # their rows report it pre-reset
            assert trf.any()
            saw_done = True
            np.testing.assert_array_equal(inf_f["ep_steps"][trf], 4)
            last = trf
        if i == 4:
            np.testing.assert_array_equal(inf_f["ep_steps"][last], 1)
    assert saw_done


def test_multi_drone_compete_and_guards():
    B = 128
    venv = TorchRaceVectorEnv(B, config="twogates", num_drones=2,
                              device="cpu")
    assert venv.spec_.racemode == RaceMode.COMPETE
    assert venv.single_action_space.shape == (2, 4)
    obs, _ = venv.reset(seed=0)
    assert obs.shape == (B, 2, venv.spec_.obs_size)
    o, r, te, tr, info = venv.step(np.zeros((B, 2, 4), np.float32))
    assert r.shape == (B, 2) and info["current_gate"].shape == (B, 2)
    assert info["task_completed"].shape == (B,)
    with pytest.raises(RuntimeError, match="reset"):
        TorchRaceVectorEnv(128, config="twogates", device="cpu").step(
            np.zeros((128, 4), np.float32))
    with pytest.raises(ValueError, match="fused"):
        TorchRaceVectorEnv(64, config="twogates", backend="fused",
                           device="cpu")
    with pytest.raises(ValueError, match="per_drone_reward"):
        TorchRaceVectorEnv(64, config="twogates", per_drone_reward=True,
                           device="cpu")
    v64 = TorchRaceVectorEnv(64, config="twogates", device="cpu")
    assert not v64.fused_backend
    o, _ = v64.reset(seed=0)
    assert o.shape == (64, v64.spec_.obs_size)
    v64.step(np.zeros((64, 4), np.float32))
