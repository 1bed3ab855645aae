"""Port: the user controllers (gym_pybullet_adrp_tpu_torch/agents),
``utils.load_controller`` and sim.py against the JAX package's on CPU.

* Every port agent's first three actions against the repo's JAX-package
  agent (agents/*.py) on the same observations: commands and their
  arguments equal (RL targets atol 1e-5: each package's float32 MLP);
  ``rl_twogates`` reaches gate 2 within 250 steps
  (tests/test_agents.py:41-55).
* ``sim.py``'s per-run line equal to scripts/sim.py's on a getting_started
  cut to 10 steps; the full flagship flight (both drones through 4
  gates, ~40 s here) is ``slow``.
"""

import contextlib
import io

import numpy as np
import pytest

from gym_pybullet_adrp_tpu.utils.utils import load_controller as jload
from gym_pybullet_adrp_tpu_torch import sim
from gym_pybullet_adrp_tpu_torch.envs.race import MultiRaceAviary
from gym_pybullet_adrp_tpu_torch.utils.enums import Command
from gym_pybullet_adrp_tpu_torch.utils.utils import load_controller

from _torch_port import REPO, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


AGENTS = [("hardcoded", "getting_started"),
          ("hardcoded_twogates", "twogates"), ("hover", "getting_started"),
          ("rl_agent", "getting_started"), ("rl_fulltrack", "getting_started"),
          ("rl_twogates", "twogates")]


def _same_action(p, j):
    if isinstance(j, np.ndarray):
        np.testing.assert_array_equal(p, j)
        return
    assert int(p[0]) == int(j[0])
    assert len(p[1]) == len(j[1])
    for x, y in zip(p[1], j[1]):
        np.testing.assert_allclose(np.asarray(x, float), np.asarray(y, float),
                                   atol=1e-5)


@pytest.mark.parametrize("name,config", AGENTS, ids=[a for a, _ in AGENTS])
def test_agent_first_actions_match_jax(name, config):
    env = MultiRaceAviary(config, num_drones=1, device="cpu")
    obs, info = env.reset()
    info = dict(info, delay=0, device="cpu")
    agent = load_controller(name)(0, obs[0], info)
    jagent = jload(f"agents/{name}.py")(0, obs[0], dict(info))
    for i in range(3):
        a = agent.predict(obs[0], ep_time=i / env.CTRL_FREQ)
        _same_action(a, jagent.predict(obs[0], ep_time=i / env.CTRL_FREQ))
        if isinstance(a, np.ndarray):
            assert a.shape[-1] == 4 and np.isfinite(a).all()
            obs, *_ = env.step(np.asarray([a]))
        else:
            assert isinstance(a[0], Command)
            obs, *_ = env.step([a])
    assert np.isfinite(obs).all()
    assert load_controller(REPO / "gym_pybullet_adrp_tpu_torch/agents"
                           / f"{name}.py").__name__ == type(agent).__name__


def test_rl_twogates_reaches_gate_2():
    env = MultiRaceAviary("twogates", num_drones=1, device="cpu")
    obs, info = env.reset()
    agent = load_controller("rl_twogates")(0, obs[0],
                                           dict(info, device="cpu"))
    for i in range(250):
        a = agent.predict(obs[0], ep_time=i / env.CTRL_FREQ)
        obs, reward, te, tr, _ = env.step([a])
        if int(env.current_gate[0]) >= 2 or te or tr:
            break
    assert int(env.current_gate[0]) >= 2


def _run_line(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        times = fn()
    return times, [ln for ln in out.getvalue().splitlines()
                   if ln.startswith("[run")]


def test_sim_line_matches_jax_script(tmp_path):
    import importlib.util

    text = (REPO / "configs/getting_started.yaml").read_text()
    cfg = tmp_path / "short.yaml"
    cfg.write_text(text.replace("episode_len_sec: 33",
                                "episode_len_sec: 0.4"))
    s = importlib.util.spec_from_file_location("jsim",
                                               REPO / "scripts/sim.py")
    jsim = importlib.util.module_from_spec(s)
    s.loader.exec_module(jsim)
    jt, jl = _run_line(lambda: jsim.simulate(str(cfg), "agents/hardcoded.py",
                                             n_runs=1, n_drones=2))
    pt, pl = _run_line(lambda: sim.simulate(str(cfg), "hardcoded", n_runs=1,
                                            n_drones=2, device="cpu"))
    assert pt == jt and pl == jl and len(pl) == 1


@pytest.mark.slow
def test_sim_flagship_flight():
    """The flagship race CLI check: both drones pass 4 gates, finish at 14.36 s
    sim time."""
    times, lines = _run_line(lambda: sim.simulate(
        "getting_started", "hardcoded", n_runs=1, n_drones=2, device="cpu"))
    assert "gates [4 4]" in lines[0] and "finished [ True  True]" in lines[0]
    assert abs(times[0] - 14.36) < 1e-6
