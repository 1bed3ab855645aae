"""Port: flight_report.py and replay_viewer.py against the JAX scripts on
CPU, and the report figure.

* ``replay_viewer.build_html`` byte-equal to the JAX script's on the
  synthetic episode of tests/test_utils.py:161, with that test's
  assertions (the embedded data, the player, the page's size).
* ``flight_report.record_episode`` on twogates, 1 drone, the scripted
  twogates racer, the episode cut to 3 s (both packages read the same
  cut YAML), the port's reset state the JAX env's (``to_port``): the
  same event kinds, drones and labels (gate 1 at 2.76 s), each event's
  time within one control step of the JAX one; the poses within 1e-3 m
  after the first step and within 5e-2 m over the episode. The closed
  loop does not transfer tighter: from the second step on, the
  firmware's tick gating fires on other ticks in jitted JAX than in the
  port (ROADMAP, "Numerics"), which moves the drone by 3.2 mm on step 2
  and by up to 2.9 cm by step 9, after which the Mellinger tracking pulls
  the two flights back together (5-10 mm). The learned racer's flight
  does not transfer at all: its targets feed the pose back, and the two
  flights part by 0.1 m within 7 steps.
* ``render_report`` writes a PNG figure (matplotlib, imported there
  only); the scripts' ``main``s on the port.
"""

import json
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from gym_pybullet_adrp_tpu.envs.race import MultiRaceAviary as JRace
from gym_pybullet_adrp_tpu_torch import flight_report, replay_viewer
from gym_pybullet_adrp_tpu_torch.envs import race as prace

from _torch_port import REPO, one_thread, to_port  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

sys.path.insert(0, str(REPO / "scripts"))
import flight_report as jax_report  # noqa: E402
import replay_viewer as jax_viewer  # noqa: E402

FIRST_POSE_ATOL = 1e-3
POSE_ATOL = 5e-2
EPISODE_SEC = 3.0


def _synthetic():
    T, N = 12, 2
    poses = np.cumsum(np.full((T, N, 6), 0.05), axis=0)
    events = [(0.2, 0, "gate", "G1"), (0.3, 1, "elim", "ELIMINATED"),
              (0.4, 0, "finish", "FINISH")]
    track = {"gates": np.zeros((4, 7)), "obstacles": np.zeros((4, 6))}
    return poses, events, track


def test_build_html_matches_jax(tmp_path):
    poses, events, track = _synthetic()
    html = replay_viewer.build_html(poses, None, events, track, 30.0,
                                    "unit test")
    assert html == jax_viewer.build_html(poses, None, events, track, 30.0,
                                         "unit test")
    m = re.search(r"const D = (\{.*?\});\nconst COLORS = (\[.*?\]);",
                  html, re.S)
    d = json.loads(m.group(1))
    colors = json.loads(m.group(2))
    assert len(d["poses"]) == 12 and len(d["poses"][0]) == 2
    assert len(colors) == 2 and all(c.startswith("#") for c in colors)
    assert d["status"][-1][1] == 2 and d["status"][-1][0] == 1
    assert "requestAnimationFrame" in html and "<canvas" in html
    out = tmp_path / "replay.html"
    out.write_text(html)
    assert out.stat().st_size > 8000
    assert flight_report.DRONE_COLORS == jax_report.DRONE_COLORS


@pytest.fixture(scope="module")
def cut_config(tmp_path_factory):
    text = (REPO / "configs/twogates.yaml").read_text()
    assert "episode_len_sec: 33" in text
    path = tmp_path_factory.mktemp("cfg") / "twogates_cut.yaml"
    path.write_text(text.replace("episode_len_sec: 33",
                                 f"episode_len_sec: {EPISODE_SEC}"))
    return path


@pytest.fixture(scope="module")
def episodes(cut_config):
    """(JAX episode, port episode) from the same reset state."""
    ref = jax_report.record_episode(
        str(cut_config), str(REPO / "agents/hardcoded_twogates.py"), 1)
    jenv = JRace(str(cut_config), num_drones=1)
    jenv.reset()
    reset = prace.MultiRaceAviary.reset

    def reset_to_jax(self, *a, **k):
        reset(self, *a, **k)
        self._state = to_port(jax.tree_util.tree_map(
            lambda x: np.asarray(x)[None], jenv._state), self._state)
        obs = prace.compute_obs(self.spec_, self._track, self._state)[0]
        return obs.numpy().astype(np.float64), {"answer": 42}

    mp = pytest.MonkeyPatch()
    mp.setattr(prace.MultiRaceAviary, "reset", reset_to_jax)
    try:
        got = flight_report.record_episode(str(cut_config),
                                           "hardcoded_twogates", 1,
                                           device="cpu")
    finally:
        mp.undo()
    return ref, got


def test_record_episode_matches_jax(episodes):
    (jp, jg, jev, jtr, jf), (pp, pg, pev, ptr, pf) = episodes
    assert pf == jf and pp.shape == jp.shape and pg.shape == jg.shape
    assert pp.shape[1:] == (1, 6)
    err = np.abs(pp[:, :, :3] - jp[:, :, :3]).max(axis=(1, 2))
    assert err[0] <= FIRST_POSE_ATOL and err.max() <= POSE_ATOL, err
    assert [(d, k, lbl) for _, d, k, lbl in pev] == \
        [(d, k, lbl) for _, d, k, lbl in jev]
    assert [lbl for *_, lbl in pev] == ["G1"]
    for (t, *_), (jt, *_) in zip(pev, jev):
        assert abs(t - jt) <= 1.0 / jf + 1e-9, (pev, jev)
    for k in ("gates", "obstacles"):
        np.testing.assert_array_equal(ptr[k], jtr[k])


def test_render_report_writes_a_png(episodes, tmp_path):
    poses, gates_t, events, track, freq = episodes[1]
    out = flight_report.render_report(poses, gates_t, events, track, freq,
                                      tmp_path / "sub/report.png",
                                      title="twogates")
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert out.stat().st_size > 20000


def test_mains(cut_config, tmp_path, capsys):
    out = replay_viewer.main(["--config", str(cut_config), "--controller",
                              "rl_twogates", "--n_drones", "1", "--out",
                              str(tmp_path / "r.html"), "--device", "cpu"])
    assert "requestAnimationFrame" in Path(out).read_text()
    png = flight_report.main(["--config", str(cut_config), "--controller",
                              "rl_twogates", "--n_drones", "1", "--out",
                              str(tmp_path / "f.png"), "--device", "cpu"])
    assert png.exists()
    text = capsys.readouterr().out
    assert "drone 0: G1" in text and "report:" in text
