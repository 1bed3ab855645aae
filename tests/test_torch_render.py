"""Port: the ray-casting renderer (ops/render.py) and the two RGB
observations (envs/race_rl.compute_rgb_obs, envs/rl.compute_rgb_obs)
against the JAX package on CPU.

The JAX functions run eagerly (``jax.disable_jit``): under ``jit``, XLA's
CPU compiler contracts multiply-adds into fused ones (the ray directions'
``forward + x * right``, the norms' sums of squares), which moves a
grazing ray's ground hit by 2e-5 of its depth and, in one of 122,880
pixels of 40 poses measured, a silhouette pixel from a gate beam to the
ground. Eagerly, every operation is rounded on its own, as the port (and
the card) round them; the port's cross products and square roots are
computed to match (ops/render.py), so the renders agree.

Tolerances: ``seg`` equal in every pixel; depth 1e-6 relative; rgba 1e-3
absolute (of 255); the flat observations in [0, 1] 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_adrp_tpu.envs import race_rl as jrl
from gym_pybullet_adrp_tpu.envs import rl as jrlenv
from gym_pybullet_adrp_tpu.envs.core import AviaryConfig as JAviaryConfig
from gym_pybullet_adrp_tpu.models import drone as jdrone
from gym_pybullet_adrp_tpu.ops import render as jr
from gym_pybullet_adrp_tpu.utils import enums as jenums
from gym_pybullet_adrp_tpu_torch.convert import (
    drone_params_from_numpy, rl_state_from_numpy,
)
from gym_pybullet_adrp_tpu_torch.envs import race_rl as prl
from gym_pybullet_adrp_tpu_torch.envs import rl as prlenv
from gym_pybullet_adrp_tpu_torch.envs.core import AviaryConfig
from gym_pybullet_adrp_tpu_torch.ops import render as pr

from _torch_port import one_thread, race_specs, to_port  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

F64 = torch.float64
# the JAX comparisons share one frame size and batch, so that the eager
# JAX operations compile once for the file
B, W, H, FOV = 8, 64, 48, 110.0


def _t(x, dtype=F64):
    return torch.tensor(x, dtype=dtype)


# ---- tests/test_render.py, on the port -------------------------------------


def test_ground_and_sky():
    scene = pr.empty_scene(F64, "cpu")
    cam = _t([0.0, 0.0, 1.0])
    # looking down: all ground
    rgba, depth, seg = pr.render(scene, cam, _t([0.0, 0.0, 0.0]), width=16,
                                 height=12)
    assert (seg == 0).all()
    assert abs(float(depth[6, 8]) - 1.0) < 0.1
    # looking up: all sky
    rgba, depth, seg = pr.render(scene, cam, _t([0.0, 0.0, 2.0]), width=16,
                                 height=12)
    assert (seg == -1).all() and (depth == 1000.0).all()
    assert rgba.shape == (12, 16, 4) and seg.dtype == torch.int32


def test_sphere_hit_and_depth():
    scene = pr.empty_scene(F64, "cpu")._replace(
        sph_center=_t([[2.0, 0.0, 1.0]]), sph_radius=_t([0.5]),
        sph_color=_t([[1.0, 0.0, 0.0]]), sph_valid=torch.tensor([True]))
    rgba, depth, seg = pr.render(scene, _t([0.0, 0.0, 1.0]),
                                 _t([2.0, 0.0, 1.0]), width=32, height=24)
    assert int(seg[12, 16]) == 1  # the first (only) sphere's id
    assert abs(float(depth[12, 16]) - 1.5) < 0.01


def test_capsule_hit():
    scene = pr.empty_scene(F64, "cpu")._replace(
        cap_center=_t([[2.0, 0.0, 0.5]]), cap_half=_t([0.5]),
        cap_radius=_t([0.1]), cap_color=_t([[0.0, 0.0, 1.0]]),
        cap_valid=torch.tensor([True]))
    rgba, depth, seg = pr.render(scene, _t([0.0, 0.0, 0.5]),
                                 _t([2.0, 0.0, 0.5]), width=32, height=24)
    assert int(seg[12, 16]) == 1
    # the center pixel is half a pixel off the axis: allow the slant
    assert abs(float(depth[12, 16]) - 1.9) < 0.02


def test_batched_cameras_and_scenes():
    """A batch of cameras renders each frame as a lone call does, with a
    shared or a per-camera scene (leaves broadcast), and a straight-down
    camera beside a level one takes its own fallback basis."""
    scene = pr.add_landmarks(pr.empty_scene(torch.float32, "cpu"))
    eyes = torch.tensor([[0.0, 0.0, 1.0], [0.3, -0.2, 0.4],
                         [-1.0, 0.5, 0.2]])
    targets = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.1],
                            [1.0, 0.0, 0.1]])
    batch = pr.render(scene, eyes, targets, 24, 16, 75.0)
    for i in range(3):
        one = pr.render(scene, eyes[i], targets[i], 24, 16, 75.0)
        for a, b in zip(batch, one):
            assert torch.equal(a[i], b)
    spheres = pr.drone_spheres(scene, eyes[:, None] + 0.5)
    batch = pr.render(spheres, eyes, targets, 24, 16)
    for i in range(3):
        one = pr.render(pr.drone_spheres(scene, eyes[i:i + 1] + 0.5),
                        eyes[i], targets[i], 24, 16)
        assert torch.equal(batch[2][i], one[2])
    assert (batch[2][0] == 0).all()


# ---- against the JAX package -----------------------------------------------


def _race_state(B, seed):
    """A JAX reset of B getting_started envs (one drone) and the port's
    copy of it."""
    pspec, ptrack, jspec, jtrack = race_specs("getting_started", 1)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    jst = jax.jit(jax.vmap(lambda k: jrl.rl_race_reset(jspec, jtrack, k)))(
        keys)
    pst = prl.rl_race_reset(pspec, ptrack, B, device="cpu")
    return pspec, jspec, jst, to_port(jst, pst)


def _assert_frames(got, ref, tag):
    rgba, depth, seg = (x.numpy() for x in got)
    jrgba, jdepth, jseg = (np.asarray(x) for x in ref)
    bad = np.argwhere(seg != jseg)
    assert bad.size == 0, f"{tag}: seg differs at {bad[:8].tolist()}"
    np.testing.assert_allclose(depth, jdepth, rtol=1e-6, atol=0, err_msg=tag)
    np.testing.assert_allclose(rgba, jrgba, rtol=0, atol=1e-3, err_msg=tag)


def test_render_matches_jax_race_scene():
    """8 seeded camera poses around a JAX-reset getting_started scene at
    64x48 and 110 degrees (the camera-racing recipe's frame), one
    vmapped JAX call; one pose grazes the ground, one looks straight
    down."""
    _, _, jst, pst = _race_state(B, 3)
    gates = np.asarray(jst.race.gates_actual)[0]
    rng = np.random.default_rng(0)
    eye = rng.uniform([-1.5, -2.0, 0.1], [1.5, 2.0, 1.5], (B, 3))
    tgt = gates[rng.integers(0, len(gates), B), :3] + rng.normal(0, 0.5,
                                                                (B, 3))
    eye, tgt = eye.astype(np.float32), tgt.astype(np.float32)
    eye[0, 2] = 0.02
    tgt[1] = eye[1] - [0.0, 0.0, 1.0]
    rs = jst.race
    with jax.disable_jit():
        ref = jax.vmap(lambda g, o, p, e, t: jr.render(
            jr.scene_from_race_state(g, o, p), e, t, W, H, FOV))(
            rs.gates_actual, rs.obstacles_actual, rs.phys.pos,
            jnp.asarray(eye), jnp.asarray(tgt))
    prs = pst.race
    scene = pr.scene_from_race_state(prs.gates_actual, prs.obstacles_actual,
                                     prs.phys.pos)
    got = pr.render(scene, torch.from_numpy(eye), torch.from_numpy(tgt), W,
                    H, FOV)
    _assert_frames(got, ref, "race scene")
    ids = np.unique(got[2].numpy())
    assert -1 in ids and 0 in ids and ids.max() > 10


def test_race_rgb_obs_matches_jax():
    """``race_rl.compute_rgb_obs``, both cameras, on 8 JAX states: four
    fly faster than 0.05 m/s horizontally (the gimbal follows the
    velocity), four slower (it falls back to body +x)."""
    pspec, jspec, jst, pst = _race_state(B, 11)
    rng = np.random.default_rng(2)
    ph = jst.race.phys
    vel = rng.uniform(-0.8, 0.8, (B, 1, 3)).astype(np.float32)
    vel[4:, :, :2] *= np.float32(0.04)   # below 0.05 m/s horizontally
    vel[7] = 0.0
    q = rng.normal(size=(B, 1, 4)) * [0.15, 0.15, 0.6, 0.0] + [0, 0, 0, 1]
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    pos = np.asarray(ph.pos) + rng.uniform(-0.3, 0.3, (B, 1, 3)).astype(
        np.float32)
    jst = jst._replace(race=jst.race._replace(phys=ph._replace(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel), quat=jnp.asarray(q))))
    pst = to_port(jst, pst)
    for camera in ("body", "velocity"):
        with jax.disable_jit():
            ref = jax.vmap(lambda s: jrl.compute_rgb_obs(
                jspec, s, W, H, FOV, camera))(jst)
        got = prl.compute_rgb_obs(pspec, pst, W, H, FOV, camera)
        assert got.shape == (B, W * H * 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5, err_msg=camera)
    assert (got >= 0).all() and (got <= 1).all()


@pytest.mark.parametrize("n", [1, 2])
def test_hover_rgb_obs_matches_jax(n):
    """``rl.compute_rgb_obs``: landmarks, and with 2 drones the other
    drone's sphere, from drone 0's camera."""
    acfg = dict(num_drones=n, ctrl_freq=30)
    jcfg = jrlenv.RLConfig(aviary=JAviaryConfig(**acfg))
    cfg = prlenv.RLConfig(aviary=AviaryConfig(**acfg))
    init = np.array([[0.0, 0.0, 0.3], [0.6, 0.1, 0.35]])[:n]
    j1 = jrlenv.rl_reset(jcfg, init, np.zeros((n, 3)))
    rng = np.random.default_rng(n)
    pos = (np.asarray(j1.core.phys.pos)[None]
           + rng.uniform(-0.2, 0.2, (B, n, 3))).astype(np.float32)
    q = rng.normal(size=(B, n, 4)) * [0.2, 0.2, 1.0, 0.0] + [0, 0, 0, 1]
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    jst = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                                 j1)
    jst = jst._replace(core=jst.core._replace(phys=jst.core.phys._replace(
        pos=jnp.asarray(pos), quat=jnp.asarray(q))))
    jp = jdrone.drone_params(jenums.DroneModel.CF2X, dtype=jnp.float32)
    with jax.disable_jit():
        ref = jax.vmap(lambda s: jrlenv.compute_rgb_obs(jcfg, jp, s, W, H))(
            jst)
    got = prlenv.compute_rgb_obs(cfg, drone_params_from_numpy(jp, "cpu"),
                                 rl_state_from_numpy(jst, "cpu"), W, H)
    assert got.shape == (B, H * W * 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
