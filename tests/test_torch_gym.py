"""Port: the gym classes (envs/aviary.py), the batched hover env
(envs/vector.py) and ``register()``, against the JAX package's classes
on CPU.

* ``CtrlAviary``, ``VelocityAviary``, ``HoverAviary`` (RPM and PID) and
  ``MultiHoverAviary``: spaces equal (bounds, shapes, dtypes); reset obs
  equal to 1e-6; 6 steps of the same actions in closed loop, obs atol
  1e-4 and rtol 1e-6 (float32 physics, and for the PID classes the
  controller's D-term on each package's rounding of the Euler angles;
  rpm ~ 1.7e4 differ by an ulp, 2e-3), rewards atol
  1e-4, flags and infos equal.
* ``TorchVectorEnv`` against ``JaxVectorEnv``: batched spaces and
  metadata, obs, rewards and flags at the same tolerances over a run
  that ends episodes (full throttle: the tilt and bounds truncation),
  the SAME-STEP autoreset's infos under both spellings with the terminal
  obs at atol 1e-4, step before reset raising, and the seeded jitter
  (equal seeds equal bit for bit; the law of the draws, not their
  values, is the JAX package's).
* ``register()``: the five ids, and ``gymnasium.make`` giving
  ``gymnasium.Env`` instances of the port's classes.
"""

import gymnasium
import numpy as np
import pytest

from gym_pybullet_adrp_tpu.envs import aviary as jav
from gym_pybullet_adrp_tpu.envs.vector import JaxVectorEnv
from gym_pybullet_adrp_tpu.utils import enums as jenums
import gym_pybullet_adrp_tpu_torch as port
from gym_pybullet_adrp_tpu_torch.envs import aviary as pav
from gym_pybullet_adrp_tpu_torch.envs.race import MultiRaceAviary
from gym_pybullet_adrp_tpu_torch.envs.vector import TorchVectorEnv
from gym_pybullet_adrp_tpu_torch.utils.enums import ActionType

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-4


def assert_boxes_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.low, b.low)
    np.testing.assert_array_equal(a.high, b.high)


CASES = {
    "ctrl": ("CtrlAviary", {}, lambda e, rng: np.full(
        (1, 4), e.HOVER_RPM * 1.02) + rng.uniform(-200, 200, (1, 4))),
    "velocity": ("VelocityAviary", {}, lambda e, rng: np.array(
        [[0.3, -0.2, 0.5, 0.4]]) + rng.uniform(-0.1, 0.1, (1, 4))),
    "hover": ("HoverAviary", {}, lambda e, rng: rng.uniform(-1, 1, (1, 4))),
    "hover-pid": ("HoverAviary", {"act": "PID"},
                  lambda e, rng: rng.uniform(-1, 1, (1, 3))),
    "multihover": ("MultiHoverAviary", {},
                   lambda e, rng: rng.uniform(-1, 1, (2, 4))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_aviary_matches_jax(case):
    name, kw, action = CASES[case]
    jkw = {k: jenums.ActionType[v] for k, v in kw.items()}
    pkw = {k: ActionType[v] for k, v in kw.items()}
    jenv = getattr(jav, name)(**jkw)
    penv = getattr(pav, name)(device="cpu", **pkw)
    assert_boxes_equal(penv.action_space, jenv.action_space)
    assert_boxes_equal(penv.observation_space, jenv.observation_space)
    for k in ("NUM_DRONES", "CTRL_FREQ", "PYB_FREQ", "PYB_STEPS_PER_CTRL",
              "HOVER_RPM", "MAX_RPM", "SPEED_LIMIT", "M", "L", "KF"):
        assert getattr(penv, k) == pytest.approx(getattr(jenv, k),
                                                 rel=1e-6), k
    np.testing.assert_array_equal(penv.INIT_XYZS, jenv.INIT_XYZS)
    jo, ji = jenv.reset(seed=0)
    po, pi = penv.reset(seed=0)
    assert po.dtype == jo.dtype and pi == ji
    np.testing.assert_allclose(po, jo, atol=1e-6)
    rng = np.random.default_rng(1)
    for i in range(6):
        a = action(penv, rng).astype(np.float32)
        jr = jenv.step(a)
        pr = penv.step(a)
        assert pr[0].shape == jr[0].shape and pr[0].dtype == jr[0].dtype
        np.testing.assert_allclose(pr[0], jr[0], atol=ATOL, rtol=1e-6,
                                   err_msg=f"{case} step {i}")
        assert pr[1] == pytest.approx(jr[1], abs=ATOL)
        assert pr[2:] == jr[2:]
    np.testing.assert_allclose(penv._getDroneStateVector(0),
                               jenv._getDroneStateVector(0), atol=ATOL,
                               rtol=1e-6)
    assert penv.step_counter == jenv.step_counter


def test_aviary_camera_refused():
    """The camera, refused until the renderer was ported: now an RGB
    ``HoverAviary`` builds and ``CtrlAviary`` renders its drone's POV
    (frame, depth and seg of the reference's 64x48; the frames' values
    are held against the JAX classes in tests/test_torch_pixels.py)."""
    from gym_pybullet_adrp_tpu_torch.utils.enums import ObservationType

    env = pav.HoverAviary(obs=ObservationType.RGB, device="cpu")
    assert env.reset()[0].shape == (1, 48, 64, 4)
    env = pav.CtrlAviary(device="cpu")
    env.reset()
    rgb, dep, seg = env._getDroneImages(0)
    assert rgb.shape == (48, 64, 4) and dep.shape == seg.shape == (48, 64)


@pytest.mark.parametrize("task", ["hover", "multihover"])
def test_vector_env_matches_jax(task):
    B = 4
    jv = JaxVectorEnv(B, task=task, ctrl_freq=30)
    pv = TorchVectorEnv(B, task=task, ctrl_freq=30, device="cpu")
    for sp in ("single_observation_space", "single_action_space",
               "observation_space", "action_space"):
        assert_boxes_equal(getattr(pv, sp), getattr(jv, sp))
    assert pv.metadata["autoreset_mode"] == jv.metadata["autoreset_mode"]
    with pytest.raises(RuntimeError, match="reset"):
        pv.step(np.zeros(pv.action_space.shape, np.float32))
    jo, _ = jv.reset(seed=0)
    po, _ = pv.reset(seed=0)
    np.testing.assert_allclose(po, jo, atol=1e-6)
    o0 = po.copy()
    # envs 0-1 at full throttle end their episodes (tilt or bounds)
    act = np.zeros(pv.action_space.shape, np.float32)
    act[:2] = 1.0
    act[2:] = np.random.default_rng(2).uniform(-0.3, 0.3, act[2:].shape)
    n_done, i = 0, 0
    while n_done < 2 and i < 60:
        i += 1
        jr = jv.step(act)
        pr = pv.step(act)
        np.testing.assert_allclose(pr[0], jr[0], atol=ATOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(pr[1], jr[1], atol=ATOL)
        np.testing.assert_array_equal(pr[2], jr[2])
        np.testing.assert_array_equal(pr[3], jr[3])
        assert pr[4].keys() == jr[4].keys()
        if pr[4]:
            n_done += 1
            for k in ("_final_obs", "_final_observation", "_final_info"):
                np.testing.assert_array_equal(pr[4][k], jr[4][k])
            for e in np.flatnonzero(pr[4]["_final_obs"]):
                np.testing.assert_allclose(pr[4]["final_obs"][e],
                                           jr[4]["final_obs"][e], atol=ATOL)
                assert pr[4]["final_observation"][e] is pr[4]["final_obs"][e]
                assert pr[4]["final_info"][e] == {}
                np.testing.assert_allclose(pr[0][e], o0[e], atol=1e-6)
    assert n_done >= 2


def test_vector_env_seeded_jitter():
    B = 64
    v = TorchVectorEnv(B, init_pos_jitter=0.1, init_rpy_jitter=0.05,
                       device="cpu")
    o1, _ = v.reset(seed=1)
    o1b, _ = v.reset(seed=1)
    o2, _ = v.reset(seed=2)
    np.testing.assert_array_equal(o1, o1b)
    assert not np.allclose(o1, o2) and not np.allclose(o1[0], o1[1])
    d = o1[:, 0, :3] - np.array([0.0, 0.0, v._proto.INIT_XYZS[0, 2]])
    assert np.abs(d).max() <= 0.1 and np.abs(d).max() > 0.05
    assert np.abs(o1[:, 0, 3:6]).max() <= 0.05 + 1e-6
    act = np.full((B, 1, 4), 0.3, np.float32)
    v.reset(seed=3)
    tr1 = np.stack([v.step(act)[0] for _ in range(3)])
    v.reset(seed=3)
    tr2 = np.stack([v.step(act)[0] for _ in range(3)])
    np.testing.assert_array_equal(tr1, tr2)
    v0 = TorchVectorEnv(4, device="cpu")
    np.testing.assert_array_equal(v0.reset(seed=1)[0], v0.reset(seed=2)[0])


def test_register_and_make():
    saved = {i: gymnasium.registry.get(i) for i in port.ENV_IDS}
    try:
        port.register()
        for env_id in port.ENV_IDS:
            assert env_id in gymnasium.registry
            kw = ({"race_config": "getting_started"} if "race" in env_id
                  else {})
            env = gymnasium.make(env_id, device="cpu", **kw)
            base = env.unwrapped
            assert isinstance(base, gymnasium.Env)
            assert isinstance(base, (pav.AviaryBase, MultiRaceAviary))
            obs, _ = env.reset(seed=0)
            assert env.observation_space.shape == obs.shape
            env.close()
    finally:
        for env_id, spec in saved.items():
            gymnasium.registry.pop(env_id, None)
            if spec is not None:
                gymnasium.registry[env_id] = spec
