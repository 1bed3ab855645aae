"""Port: flight_report.record_episode against the JAX env step by step, on
CPU: getting_started, 1 drone, the scripted racer, flown to its end (it
passes the four gates and finishes: the FINISH branch).

Each control step starts from the JAX side: the JAX env's state is copied
into the port's env (``to_port``, as tests/test_torch_wrappers.py does)
and the JAX env takes the same command. So the recorder's bookkeeping is
held per step, free of the closed loop's drift (tests/test_torch_reports.py
holds the free flight):

* each step's pose within 5e-3 m of the JAX env's after the same step
  (one step's firmware tick gating, which fires on other ticks in jitted
  JAX than in the port, moves the drone by up to ~3 mm: ROADMAP,
  "Numerics");
* each step's gate counts equal, and the episode as long as the JAX
  env's (its first done);
* the events exactly those the JAX script's rule gives on the JAX env's
  counts (scripts/flight_report.py:80-87), times included.
"""

import copy

import jax
import numpy as np
import pytest

from gym_pybullet_adrp_tpu.envs.race import MultiRaceAviary as JRace
from gym_pybullet_adrp_tpu.utils import enums as jenums
from gym_pybullet_adrp_tpu_torch import flight_report
from gym_pybullet_adrp_tpu_torch.envs import race as prace

from _torch_port import one_thread, to_port  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

POSE_ATOL = 5e-3


def _jax_events(gates, finished, eliminated, freq):
    """The JAX script's event rule over per-step (T, N) counts and
    flags."""
    events = []
    n = gates.shape[1]
    prev = (np.zeros(n, int), np.zeros(n, bool), np.zeros(n, bool))
    for step, (g, f, e) in enumerate(zip(gates, finished, eliminated)):
        t = (step + 1) / freq
        for i in range(n):
            if g[i] > prev[0][i]:
                events.append((t, i, "gate", f"G{g[i]}"))
            if f[i] and not prev[1][i]:
                events.append((t, i, "finish", "FINISH"))
            if e[i] and not prev[2][i]:
                events.append((t, i, "elim", "ELIMINATED"))
        prev = (g, f, e)
    return events


def _lockstep(config, controller):
    """The port's record_episode with the JAX env's state copied in
    before each step; returns (port episode, JAX per-step record)."""
    jenv = JRace(config, num_drones=1)
    jenv.reset()
    ref = {"pose": [], "gate": [], "fin": [], "elim": [], "done": []}
    reset, step = prace.MultiRaceAviary.reset, prace.MultiRaceAviary.step

    def copy_in(self):
        self._state = to_port(jax.tree_util.tree_map(
            lambda x: np.asarray(x)[None], jenv._state), self._state)

    def reset_to_jax(self, *a, **k):
        reset(self, *a, **k)
        copy_in(self)
        obs = prace.compute_obs(self.spec_, self._track, self._state)[0]
        return obs.numpy().astype(np.float64), {"answer": 42}

    def step_from_jax(self, actions):
        copy_in(self)
        jo, _, te, tr, _ = jenv.step(
            [(jenums.Command(int(c)), copy.deepcopy(a)) for c, a in actions])
        jo = np.asarray(jo)
        ref["pose"].append(np.concatenate([jo[:, 0:3], jo[:, 6:9]], 1))
        ref["gate"].append(np.asarray(jenv.current_gate, int).copy())
        ref["fin"].append(np.asarray(jenv.drones_finished, bool).copy())
        ref["elim"].append(np.asarray(jenv.drones_eliminated, bool).copy())
        ref["done"].append(bool(te or tr))
        return step(self, actions)

    mp = pytest.MonkeyPatch()
    mp.setattr(prace.MultiRaceAviary, "reset", reset_to_jax)
    mp.setattr(prace.MultiRaceAviary, "step", step_from_jax)
    try:
        got = flight_report.record_episode(config, controller, 1,
                                           device="cpu")
    finally:
        mp.undo()
    return got, {k: np.asarray(v) for k, v in ref.items()}


def test_record_episode_lockstep_finishes_as_jax():
    (poses, gates_t, events, _, freq), ref = _lockstep("getting_started",
                                                       "hardcoded")
    T = len(ref["done"])
    assert poses.shape == (T, 1, 6) and gates_t.shape == (T, 1)
    # the episode ends on the JAX env's first done
    assert ref["done"][-1] and not ref["done"][:-1].any()
    err = np.abs(poses - ref["pose"])[:, :, :3].max(axis=(1, 2))
    assert err.max() <= POSE_ATOL, (err.argmax(), err.max())
    np.testing.assert_array_equal(gates_t, ref["gate"])
    assert events == _jax_events(ref["gate"], ref["fin"], ref["elim"], freq)
    assert [lbl for *_, lbl in events] == ["G1", "G2", "G3", "G4",
                                            "FINISH"]
