"""Port: examples/race_video.py and the PNG writer of utils/rendering.py
against the JAX package on CPU.

* ``png_bytes``: decoded by PIL, equal to the array (RGBA, RGB, grey);
  ``read_png`` inverts it. ``export_image`` writes, for RGB frames,
  depth, segmentation and BW, the image the JAX package's PIL-based
  ``export_image`` writes (both decoded, equal in every pixel).
* The chase frame (``race_video.chase_frame``) from the JAX class's state
  (copied into the port's env, ``to_port``) equal bit for bit to the
  eager JAX render of that state (tests/test_torch_render.py says why
  eagerly), rgba, depth and seg.
* ``run(frames=3, 64 x 48)`` against the JAX ``run``: the same number of
  frames, each equal in >= 99% of its pixels (the JAX example renders
  under ``jit``, whose fused multiply-adds move some grazing rays), the
  port's env state set after each step to the JAX env's state at that
  step. Left to fly its own closed loop, the port's drones part from the
  JAX ones by ~mm from the second step (the firmware's tick gating,
  ROADMAP "Numerics"), which moves the chase camera and the gates'
  edges by a pixel: 95% and 92% of the pixels of frames 2 and 3 stay
  equal at 64 x 48.
"""

import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from gym_pybullet_adrp_tpu.envs.race import MultiRaceAviary as JRace
from gym_pybullet_adrp_tpu.ops import render as jrender
from gym_pybullet_adrp_tpu.utils import rendering as jrendering
from gym_pybullet_adrp_tpu_torch.envs.race import MultiRaceAviary
from gym_pybullet_adrp_tpu_torch.examples import race_video
from gym_pybullet_adrp_tpu_torch.utils import rendering
from gym_pybullet_adrp_tpu_torch.utils.enums import ImageType

from _torch_port import REPO, one_thread, to_port  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

W, H = 64, 48
PIXEL_SHARE = 0.99


@pytest.mark.parametrize("shape", [(H, W, 4), (H, W, 3), (H, W)],
                         ids=["rgba", "rgb", "grey"])
def test_png_bytes_decode_with_pil(shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    data = rendering.png_bytes(img)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == {4: "RGBA", 3: "RGB", 2: "L"}[
            len(shape) if len(shape) == 2 else shape[2]]
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(rendering.read_png(data).reshape(shape),
                                  img)
    with pytest.raises(ValueError):
        rendering.png_bytes(img.astype(np.float32))


def test_export_image_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    frames = {
        ImageType.RGB: rng.uniform(0, 255, (H, W, 4)).astype(np.float32),
        ImageType.DEP: rng.uniform(0.1, 30.0, (H, W)).astype(np.float32),
        ImageType.SEG: rng.integers(-1, 9, (H, W)).astype(np.int32),
        ImageType.BW: rng.uniform(0, 255, (H, W, 4)).astype(np.float32),
    }
    from gym_pybullet_adrp_tpu.utils.enums import ImageType as JImageType

    for k, (t, img) in enumerate(frames.items()):
        got = rendering.export_image(t, img, str(tmp_path / "port"), k)
        ref = jrendering.export_image(JImageType(t.value), img,
                                      str(tmp_path / "jax"), k)
        assert os.path.basename(got) == os.path.basename(ref)
        with Image.open(got) as a, Image.open(ref) as b:
            assert a.mode == b.mode and a.size == b.size
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_chase_frame_matches_eager_jax():
    jenv = JRace("getting_started", num_drones=2)
    jenv.reset()
    for _ in range(3):
        jenv.step(np.array([[0.8, 0.7, 0.4, 0.0], [1.2, 1.0, 0.3, 0.0]]))
    penv = MultiRaceAviary("getting_started", num_drones=2, device="cpu")
    penv.reset()
    penv._state = to_port(jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], jenv._state), penv._state)
    rgba, depth, seg = race_video.chase_frame(penv, W, H)
    st = jenv._state
    with jax.disable_jit():
        scene = jrender.scene_from_race_state(
            st.gates_actual, st.obstacles_actual, st.phys.pos)
        target = jnp.asarray(np.asarray(st.phys.pos[0]), dtype=jnp.float32)
        eye = target + jnp.asarray(race_video.CHASE, dtype=jnp.float32)
        ref = jrender.render(scene, eye, target, width=W, height=H)
    for name, a, b in zip(("rgba", "depth", "seg"), (rgba, depth, seg), ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def _frames(path):
    names = sorted((f for f in os.listdir(path) if f.endswith(".png")),
                   key=lambda f: int(f[6:-4]))
    out = []
    for f in names:
        with open(os.path.join(path, f), "rb") as fh:
            out.append(rendering.read_png(fh.read()))
    return out


def test_run_matches_jax(tmp_path):
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import race_video as jax_video
    finally:
        sys.path.remove(str(REPO / "examples"))
    states = []
    jstep = JRace.step

    def record_jax(self, action):
        out = jstep(self, action)
        states.append(self._state)
        return out

    pstep = MultiRaceAviary.step

    def pin_to_jax(self, action):
        out = pstep(self, action)
        self._state = to_port(jax.tree_util.tree_map(
            lambda x: np.asarray(x)[None], states[self.step_counter
                                                  // self.PYB_STEPS_PER_CTRL
                                                  - 1]), self._state)
        return out

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JRace, "step", record_jax)
        jrec = jax_video.run(frames=3, out=str(tmp_path / "jax"), width=W,
                             height=H)
        mp.setattr(MultiRaceAviary, "step", pin_to_jax)
        rec = race_video.run(frames=3, out=str(tmp_path / "port"), width=W,
                             height=H, device="cpu")
    finally:
        mp.undo()
    got, ref = _frames(rec.path), [np.asarray(Image.open(
        os.path.join(jrec.path, f"frame_{i}.png"))) for i in range(3)]
    assert rec.frame_num == jrec.frame_num == len(got) == 3
    for a, b in zip(got, ref):
        assert a.shape == b.shape == (H, W, 4)
        same = np.all(a == b, axis=-1).mean()
        assert same >= PIXEL_SHARE, same
