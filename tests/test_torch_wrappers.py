"""Port: utils/wrapper.py (``DroneObservationWrapper``, ``RewardWrapper``)
over the port's ``MultiRaceAviary`` against the JAX wrappers over the JAX
class on CPU, twogates with 1 drone.

Each control step starts from the JAX side: its env state is copied into
the port's env (``to_port``, as tests/test_torch_race_surfaces.py does)
and its ``RewardWrapper`` fields into the port's wrapper; both then take
the same action. Held: the wrapped reward within 5e-3 (that file's step
tolerance: a step's firmware gating may fire on another tick across the
packages, which moves a position by up to a few mm), ``terminated``,
``truncated`` and ``current_gate_id`` equal on every step, so the
termination step is equal; the actions' yaw zeroed in place, for
FULLSTATE tuples (the learned twogates racer, flown until the wrapper
ends the episode after gate 2) and for ndarray rows (scripted targets).
"""

import copy

import jax
import numpy as np
import pytest

from gym_pybullet_adrp_tpu.envs.race import MultiRaceAviary as JRace
from gym_pybullet_adrp_tpu.utils import enums as jenums
from gym_pybullet_adrp_tpu.utils import wrapper as jwrap
from gym_pybullet_adrp_tpu_torch.envs import race as prace
from gym_pybullet_adrp_tpu_torch.envs.race import MultiRaceAviary
from gym_pybullet_adrp_tpu_torch.utils import wrapper as pwrap
from gym_pybullet_adrp_tpu_torch.utils.enums import Command
from gym_pybullet_adrp_tpu_torch.utils.utils import load_controller

from _torch_port import one_thread, to_port  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

REWARD_ATOL = 5e-3
MAX_STEPS = 60


def _copy_state(penv, jenv):
    penv._state = to_port(jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], jenv._state), penv._state)


def _pair():
    """(JAX wrapped env, port wrapped env), both reset; the port's reset
    state is the JAX env's."""
    jw = jwrap.RewardWrapper(jwrap.DroneObservationWrapper(
        JRace("twogates", num_drones=1)))
    penv = MultiRaceAviary("twogates", num_drones=1, device="cpu")
    pw = pwrap.RewardWrapper(pwrap.DroneObservationWrapper(penv))
    jo, _ = jw.reset()          # the config's seed
    reset = penv.reset

    def reset_to_jax(*a, **k):
        reset(*a, **k)
        _copy_state(penv, jw.unwrapped)
        obs = prace.compute_obs(penv.spec_, penv._track, penv._state)[0]
        return obs.numpy().astype(np.float64), {"answer": 42}

    penv.reset = reset_to_jax
    po, _ = pw.reset()
    np.testing.assert_allclose(po, jo, atol=1e-6)
    assert pw.current_gate_id == jw.current_gate_id
    return jw, pw


def _jax_action(a):
    if isinstance(a, np.ndarray):
        return a.copy()
    return [(jenums.Command(int(c)), copy.deepcopy(args)) for c, args in a]


def test_wrapper_protocol():
    penv = MultiRaceAviary("twogates", num_drones=1, device="cpu")
    w = pwrap.RewardWrapper(pwrap.DroneObservationWrapper(penv))
    assert w.unwrapped is penv and penv.unwrapped is penv
    assert w.env.env is penv
    assert w.num_gates == penv.num_gates == 4      # read through
    assert w.CTRL_FREQ == penv.CTRL_FREQ
    assert w.action_space.shape == penv.action_space.shape
    with pytest.raises(AttributeError):
        w.no_such_attribute


@pytest.mark.parametrize("actions", ["fullstate", "ndarray"])
def test_wrappers_match_jax(actions):
    jw, pw = _pair()
    obs = prace.compute_obs(pw.unwrapped.spec_, pw.unwrapped._track,
                            pw.unwrapped._state)[0].numpy()
    agent = (load_controller("rl_twogates")(0, obs[0], {"device": "cpu"})
             if actions == "fullstate" else None)
    targets = [np.array([[1.0, 0.6, 0.5, 0.3]]),
               np.array([[1.0, 0.4, 0.6, -0.2]])]
    ended = False
    for i in range(MAX_STEPS if actions == "fullstate" else 12):
        _copy_state(pw.unwrapped, jw.unwrapped)
        pw.current_gate_id = jw.current_gate_id
        pw.current_target = np.array(jw.current_target)
        pw.previous_pos = np.array(jw.previous_pos)
        if actions == "fullstate":
            pa = [agent.predict(obs[0], ep_time=i / pw.CTRL_FREQ)]
            assert pa[0][0] == Command.FULLSTATE
            pa[0][1][3] = 0.4             # a yaw for the wrapper to zero
        else:
            pa = targets[i % 2].copy()
        ja = _jax_action(pa)
        jr = jw.step(ja)
        pr = pw.step(pa)
        if actions == "fullstate":
            assert pa[0][1][3] == 0 and ja[0][1][3] == 0
        else:
            assert pa[0, 3] == 0 and ja[0, 3] == 0
        assert abs(pr[1] - jr[1]) <= REWARD_ATOL, (i, pr[1], jr[1])
        assert pr[2:4] == jr[2:4], i
        assert pw.current_gate_id == jw.current_gate_id, i
        assert pr[4]["task_completed"] == jr[4]["task_completed"]
        obs = jr[0]
        if jr[2] or jr[3]:
            ended = True
            break
    if actions == "fullstate":
        # the learned racer reaches gate 2, where the wrappers end the
        # episode, on the same step on both sides
        assert ended and int(jw.unwrapped.current_gate[0]) >= 2, i
        assert int(pw.unwrapped.current_gate[0]) >= 2
    else:
        assert not ended
