"""Port: the pixels path on CPU. ``CnnActorCritic`` against flax's with
the same weights, the shipped pixel artifacts through the port's reader
and writer, tiny ``train(obs="rgb")`` and ``rgb_hover_adapter`` PPO
runs, the trainer's guards, the pixels evaluator (tests/test_race_rl.py:
147-187 on the port), the RGB gym surfaces and the shipped pixels policy
racing in the port's closed loop (tests/test_agents.py:58-111, with its
thresholds).

Tolerances: the CNN's mean, log-std and value 1e-5 absolute against
flax's on the CPU (float32 both; the shipped artifacts' inputs are
frames in [0, 1]); the artifacts written back equal bit for bit; the
closed loop by the JAX test's floors (the JAX package's starts come
from its keys, the port's from a seeded generator: other starts).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from gym_pybullet_adrp_tpu.models.policy import CnnActorCritic as FlaxCnn
from gym_pybullet_adrp_tpu_torch import eval_race_rgb, train_race
from gym_pybullet_adrp_tpu_torch.convert import (
    cnn_actor_critic_from_flax, flax_from_cnn_actor_critic,
)
from gym_pybullet_adrp_tpu_torch.envs import race as prace
from gym_pybullet_adrp_tpu_torch.envs import race_rl as prl
from gym_pybullet_adrp_tpu_torch.envs import rl as rlenv
from gym_pybullet_adrp_tpu_torch.envs.aviary import HoverAviary
from gym_pybullet_adrp_tpu_torch.envs.core import AviaryConfig
from gym_pybullet_adrp_tpu_torch.envs.race import MultiRaceAviary
from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
from gym_pybullet_adrp_tpu_torch.models.policy import CnnActorCritic, same_pads
from gym_pybullet_adrp_tpu_torch.rl import checkpoint as pck
from gym_pybullet_adrp_tpu_torch.rl import ppo
from gym_pybullet_adrp_tpu_torch.utils.config import load_config
from gym_pybullet_adrp_tpu_torch.utils.enums import (
    ActionType, ImageType, ObservationType, Physics, RaceMode,
)

from _torch_port import REPO, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-5
ARTIFACTS = {"example_pixels_policy": (REPO / "agents/example_pixels_policy"
                                       ".msgpack", 24, 32),
             "px5_full": (REPO / "results/px5/full.msgpack", 48, 64)}


def _flax_apply(params, obs, h, w):
    net = FlaxCnn(act_dim=4, img_h=h, img_w=w)
    return jax.jit(net.apply)(params, jnp.asarray(obs))


def _assert_heads(got, ref, tag):
    for name, a, b in zip(("mean", "log_std", "value"), got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=ATOL, err_msg=f"{tag} {name}")


def test_same_padding_is_flax_s():
    """flax "SAME" at stride 2: asymmetric where the total is odd."""
    assert same_pads(64, 5, 2) == (1, 2) and same_pads(48, 5, 2) == (1, 2)
    assert same_pads(32, 3, 2) == (0, 1) and same_pads(12, 3, 2) == (0, 1)
    assert same_pads(7, 3, 2) == (1, 1) and same_pads(3, 5, 2) == (2, 2)


@pytest.mark.parametrize("h,w", [(24, 32), (48, 64)])
def test_cnn_matches_flax(h, w):
    """Random flax weights carried across; the flat (H, W, 3) frames of a
    batch, and of a (T, B) batch."""
    params = FlaxCnn(act_dim=4, img_h=h, img_w=w).init(
        jax.random.PRNGKey(h), jnp.zeros((1, h * w * 3), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["log_std"] = np.full(4, -0.5, np.float32)
    net = cnn_actor_critic_from_flax(params, h, w)
    obs = np.random.default_rng(w).uniform(0, 1, (2, 3, h * w * 3)).astype(
        np.float32)
    _assert_heads(net(torch.from_numpy(obs)),
                  _flax_apply(params, obs, h, w), f"{h}x{w}")
    back = flax_from_cnn_actor_critic(net)["params"]
    for k, v in params["params"].items():
        for kk, a in (v.items() if isinstance(v, dict) else [(None, v)]):
            b = back[k][kk] if kk else back[k]
            np.testing.assert_array_equal(b, a, err_msg=f"{k} {kk}")


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_shipped_artifacts(name, tmp_path):
    """``load_policy`` builds the CNN of a shipped pixel artifact (its
    frame size given), whose heads match flax's; ``save_policy`` writes
    the artifact's own bytes back, which flax reads equal; without
    ``img`` the reader refuses."""
    path, h, w = ARTIFACTS[name]
    net = pck.load_policy(path, device="cpu", img=(h, w))
    assert isinstance(net, CnnActorCritic) and net.dense.in_features == (
        -(-h // 8) * -(-w // 8) * 64)
    tmpl = FlaxCnn(act_dim=4, img_h=h, img_w=w).init(
        jax.random.PRNGKey(0), jnp.zeros((1, h * w * 3), jnp.float32))
    params = serialization.from_bytes(tmpl, path.read_bytes())
    obs = np.random.default_rng(1).uniform(0, 1, (6, h * w * 3)).astype(
        np.float32)
    _assert_heads(net(torch.from_numpy(obs)), _flax_apply(params, obs, h, w),
                  name)
    out = pck.save_policy(tmp_path / "again.msgpack", net)
    assert out.read_bytes() == path.read_bytes()
    back = serialization.from_bytes(tmpl, out.read_bytes())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="img"):
        pck.load_policy(path, device="cpu")


def test_train_rgb_tiny(tmp_path):
    """One ``train(obs="rgb")`` iteration at 16x12 on the general env: a
    finite loss, a CNN policy, frames of the post-step state in [0, 1];
    the policy it writes reads back as that CNN, and a warm start from it
    takes its weights."""
    out = tmp_path / "px.msgpack"
    kw = dict(config="twogates", obs="rgb", img="16x12", fov=90.0,
              camera="velocity", n_envs=8, n_steps=8, device="cpu",
              log_every=0)
    res = train_race.train(iters=1, out=str(out), **kw)
    assert np.isfinite(res["metrics"][0]["loss"])
    net = res["ts"].params
    assert isinstance(net, CnnActorCritic) and net.img == (12, 16, 3)
    obs = res["ts"].last_obs
    assert obs.shape == (8, 12 * 16 * 3) and 0 <= obs.min() <= obs.max() <= 1
    ref = prl.compute_rgb_obs(res["env"].spec, res["ts"].env_state, 16, 12,
                              90.0, "velocity")
    assert torch.equal(obs, ref)
    back = pck.load_policy(out, device="cpu", img=(12, 16))
    for a, b in zip(back.parameters(), net.parameters()):
        assert torch.equal(a, b)
    warm = train_race.train(iters=0, init=str(out), **kw)["ts"].params
    for a, b in zip(warm.parameters(), net.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(fast=True), dict(fuse_policy=True),
                                dict(n_drones=2, compete=True)],
                         ids=["fast", "fuse_policy", "n_drones"])
def test_train_rgb_guards(kw):
    """The JAX script's guards on --obs rgb (scripts/train_race.py:151-
    152, :159-160) as ValueErrors, before any env is built."""
    with pytest.raises(ValueError, match="rgb"):
        train_race.train(obs="rgb", iters=0, device="cpu", **kw)


def test_rgb_hover_ppo_iteration():
    """``make_ppo_core(network=CnnActorCritic)`` over ``rgb_hover_adapter``
    at 16x12: one iteration, a finite loss; the frames after a done are
    the reset state's; the policy's weights come from the seed."""
    cfg = ppo.PPOConfig(n_envs=8, n_steps=8, n_minibatches=2, n_epochs=2)
    rl_cfg = rlenv.RLConfig(aviary=AviaryConfig(ctrl_freq=30),
                            act_type=ActionType.ONE_D_RPM)
    params = drone_params(device="cpu")
    init = np.array([[0.0, 0.0, 0.1125]])
    adapter = ppo.rgb_hover_adapter(cfg, rl_cfg, params, init,
                                    np.zeros((1, 3)), 16, 12, device="cpu")
    assert adapter.obs_dim == 16 * 12 * 3
    net = CnnActorCritic(adapter.act_dim, img_h=12, img_w=16)
    init_fn, train_step, _ = ppo.make_ppo_core(cfg, adapter, device="cpu",
                                               network=net)
    ts = init_fn(0)
    assert isinstance(ts.params, CnnActorCritic) and ts.params is not net
    for a, b in zip(init_fn(0).params.parameters(), ts.params.parameters()):
        assert torch.equal(a, b)
    assert not torch.equal(init_fn(1).params.convs[0].weight,
                           ts.params.convs[0].weight)
    ts, m = train_step(ts)
    assert np.isfinite(float(m["loss"]))
    # an env far out of bounds ends its episode and shows the reset frame
    st = ts.env_state
    far = st.core.phys.pos.clone()
    far[0, 0, 0] = 5.0
    st = st._replace(core=st.core._replace(
        phys=st.core.phys._replace(pos=far)))
    st2, frames, _, done = adapter.step(st, torch.zeros((8, 1)))
    assert bool(done[0])
    reset, first = adapter.batched_reset()
    assert torch.equal(frames[0], first[0])
    assert torch.equal(frames, rlenv.compute_rgb_obs(rl_cfg, params, st2,
                                                     16, 12))


def test_cnn_train_state_checkpoint(tmp_path):
    """A whole-state checkpoint of a pixel PPO run (``rgb_hover_adapter``,
    a ``CnnActorCritic``) restored into a fresh template resumes equal to
    the unbroken run, bit for bit."""
    cfg = ppo.PPOConfig(n_envs=4, n_steps=4, n_minibatches=2, n_epochs=1)
    rl_cfg = rlenv.RLConfig(aviary=AviaryConfig(ctrl_freq=30),
                            act_type=ActionType.ONE_D_RPM)
    adapter = ppo.rgb_hover_adapter(cfg, rl_cfg, drone_params(device="cpu"),
                                    np.array([[0.0, 0.0, 0.1125]]),
                                    np.zeros((1, 3)), 16, 12, device="cpu")
    init_fn, train_step, _ = ppo.make_ppo_core(
        cfg, adapter, device="cpu",
        network=CnnActorCritic(1, img_h=12, img_w=16))
    ts, _ = train_step(init_fn(0))
    pck.save_checkpoint(tmp_path, ts, 1)
    unbroken, _ = train_step(ts)
    restored, step = pck.restore_checkpoint(tmp_path, init_fn(7),
                                            device="cpu")
    assert step == 1 and isinstance(restored.params, CnnActorCritic)
    resumed, _ = train_step(restored)
    for a, b in zip(resumed.params.state_dict().values(),
                    unbroken.params.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(resumed.last_obs, unbroken.last_obs)


@pytest.mark.parametrize("camera,stochastic", [("velocity", False),
                                               ("body", True)])
def test_eval_race_rgb_harness(camera, stochastic, tmp_path):
    """The pixels evaluator's telemetry accounting (tests/test_race_rl.py:
    147-187): a random 16x12 CNN, 8 envs, 3 steps, both cameras."""
    net = CnnActorCritic(4, img_h=12, img_w=16,
                         generator=torch.Generator().manual_seed(1))
    path = pck.save_policy(tmp_path / "rgb.msgpack", net)
    out = eval_race_rgb.evaluate(str(path), "twogates", n_envs=8,
                                 img="16x12", fov=90.0, camera=camera,
                                 max_steps=3, stochastic=stochastic,
                                 device="cpu")
    assert set(out) >= {"gates_hist", "completion_rate", "mean_gates",
                        "mean_lap_time", "camera"}
    assert sum(out["gates_hist"].values()) == 8
    assert out["camera"] == camera and out["steps"] == 3
    again = eval_race_rgb.main([
        "--policy", str(path), "--config", "twogates", "--envs", "8",
        "--img", "16x12", "--fov", "90", "--camera", camera,
        "--max_steps", "3", "--device", "cpu"]
        + (["--stochastic"] if stochastic else []))
    assert {k: again[k] for k in out} == out


def test_rgb_gym_surfaces(tmp_path):
    """``HoverAviary(obs=RGB)`` reset and step give (1, 48, 64, 4) frames
    of uint8 values, ``_getDroneImages`` the frame, depth and seg of one
    camera, ``_exportImage`` a PNG; ``MultiRaceAviary(obs=RGB)`` a frame
    per drone."""
    env = HoverAviary(obs=ObservationType.RGB, device="cpu")
    obs, _ = env.reset()
    assert obs.shape == (1, 48, 64, 4) and obs.dtype == np.float32
    assert env.observation_space.shape == (1, 48, 64, 4)
    obs, *_ = env.step(np.zeros((1, 4)))
    assert obs.shape == (1, 48, 64, 4) and obs.max() <= 255.0
    assert np.array_equal(obs, np.floor(obs))
    rgb, dep, seg = env._getDroneImages(0)
    assert rgb.shape == (48, 64, 4) and rgb.dtype == np.uint8
    assert dep.shape == (48, 64) and seg.shape == (48, 64)
    assert np.array_equal(rgb.astype(np.float32), obs[0])
    png = env._exportImage(ImageType.RGB, rgb, str(tmp_path / "frames"), 3)
    from PIL import Image

    with Image.open(png) as im:
        assert im.size == (64, 48) and im.mode == "RGBA"

    race = MultiRaceAviary("getting_started", num_drones=2,
                           obs=ObservationType.RGB, device="cpu")
    obs, _ = race.reset()
    assert obs.shape == (2, 48, 64, 4)
    assert race.observation_space.shape == (2, 48, 64, 4)
    obs, *_ = race.step(np.zeros((2, 4)))
    assert obs.shape == (2, 48, 64, 4) and 0 <= obs.min() <= obs.max() <= 255


def test_rgb_gym_frames_match_jax():
    """The gym classes' frames against the JAX package's classes' (run
    eagerly, as tests/test_torch_render.py says why): ``HoverAviary``'s
    RGB observation after reset, and ``MultiRaceAviary``'s from a JAX
    reset state carried across; equal values."""
    from gym_pybullet_adrp_tpu.envs import HoverAviary as JHover
    from gym_pybullet_adrp_tpu.envs.race import MultiRaceAviary as JRace
    from gym_pybullet_adrp_tpu.utils.enums import ObservationType as JObs

    from _torch_port import to_port

    with jax.disable_jit():
        jobs, _ = JHover(obs=JObs.RGB).reset()
        jrace = JRace("getting_started", num_drones=2, obs=JObs.RGB)
        jrace.reset(seed=4)
        jframes = jrace._rgbObs()
    obs, _ = HoverAviary(obs=ObservationType.RGB, device="cpu").reset()
    np.testing.assert_array_equal(obs, jobs)
    race = MultiRaceAviary("getting_started", num_drones=2,
                           obs=ObservationType.RGB, device="cpu")
    race.reset()
    jst = jax.tree_util.tree_map(lambda x: x[None], jrace._state)
    race._state = to_port(jst, race._state)
    np.testing.assert_allclose(race._rgbObs(), jframes, rtol=0, atol=1e-3)


def test_shipped_pixels_policy_races_from_raw_frames():
    """agents/example_pixels_policy.msgpack (32x24 body-camera frames)
    races twogates in the port's closed loop over 4 starts: the JAX
    test's floors, at least one start through both gates (return > 10)
    and a mean return above 4."""
    cfg = load_config("twogates")
    spec = prace.RaceSpec.from_config(cfg, 1, RaceMode.COMPARE, Physics.PYB)
    track = prace.track_tensors(prace.track_from_config(cfg, 1), "cpu")
    net = pck.load_policy(ARTIFACTS["example_pixels_policy"][0], "cpu",
                          img=(24, 32))
    B = 4
    gen = torch.Generator().manual_seed(0)
    st = prl.rl_race_reset(spec, track, B, generator=gen, device="cpu")
    ret = torch.zeros(B, dtype=torch.float64)
    done_seen = torch.zeros(B, dtype=torch.bool)
    with torch.no_grad():
        for _ in range(160):
            mean, _, _ = net(prl.compute_rgb_obs(spec, st, 32, 24))
            a = torch.clamp(mean, -1.0, 1.0).reshape(B, 1, 4)
            st, _, r, te, tr = prl.batched_rl_race_step(
                spec, track, st, a, generator=gen, end_after_gate=2)
            ret += torch.where(done_seen, 0.0, r.double())
            done_seen |= te | tr
            if done_seen.all():
                break
    assert ret.max() > 10.0, ret
    assert ret.mean() > 4.0, ret
