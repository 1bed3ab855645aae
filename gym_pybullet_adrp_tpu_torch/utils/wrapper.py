"""Wrappers for RL training on the race env.

Counterpart of gym_pybullet_adrp_tpu/utils/wrapper.py
(``DroneObservationWrapper`` :17, ``RewardWrapper`` :43; reference
utils/wrapper.py:12-186). The JAX classes subclass ``gymnasium.Wrapper``,
which asserts a ``gymnasium.Env``; the port's env classes carry the
gymnasium API without subclassing it (the card's machine has no
gymnasium, envs/aviary.py), so these are plain classes that keep the
wrapper protocol: ``env``, ``unwrapped``, the spaces and every other
attribute read through to the wrapped env, ``reset``/``step``/``close``
delegated. They wrap the port's ``MultiRaceAviary`` or another wrapper.
"""

from typing import Any

import numpy as np

from .enums import Command


class Wrapper:
    """The gymnasium wrapper protocol over any env with ``reset``/``step``:
    attributes the wrapper does not define are the wrapped env's."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        if name.startswith("__") or name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def unwrapped(self):
        return self.env.unwrapped

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def observation_space(self):
        return self.env.observation_space

    def reset(self, *args: Any, **kwargs):
        return self.env.reset(*args, **kwargs)

    def step(self, action):
        return self.env.step(action)

    def render(self, *args: Any, **kwargs):
        return self.env.render(*args, **kwargs)

    def close(self):
        return self.env.close()


class DroneObservationWrapper(Wrapper):
    """Zeroes yaw actions and ends the episode after gate 2 (reference
    wrapper.py:12-65, used for twogates training)."""

    def step(self, action):
        # yaw actions are zeroed in place (reference :52-58)
        for act in action:
            if isinstance(act, np.ndarray):
                act[3] = 0
            elif isinstance(act, tuple) and act[0] == Command.FULLSTATE:
                act[1][3] = 0

        obs, reward, terminated, truncated, info = self.env.step(action)

        # the episode ends after the first two gates (:61-63)
        if self.env.unwrapped.current_gate[0] >= 2:
            terminated = True
        return obs, reward, terminated, truncated, info


class RewardWrapper(Wrapper):
    """Dense gate-progress shaping and sparse pass, collision and lap
    terms (reference wrapper.py:68-186)."""

    def __init__(self, env):
        super().__init__(env)
        self.current_gate_id = None
        self.current_target = None
        self.previous_pos = None

    def reset(self, *args: Any, **kwargs):
        obs, info = self.env.reset(*args, **kwargs)
        self.current_gate_id = int(obs[0, -1])
        self.current_target = obs[0, 12:15]
        self.previous_pos = obs[0, :3]
        return obs, info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        reward = self._compute_reward(obs, reward, terminated, truncated,
                                      info)
        return obs, reward, terminated, truncated, info

    def _compute_reward(self, obs, reward, terminated, truncated, info):
        # sparse terms (reference :141-162)
        r_passed = 0
        gate_id = int(obs[0, -1])
        num_gates = getattr(self.env.unwrapped, "num_gates", 4)
        gate_positions = {g: obs[0, 12 + 4 * g: 16 + 4 * g]
                          for g in range(num_gates)}
        if gate_id > self.current_gate_id % num_gates:
            self.current_gate_id = gate_id
            self.current_target = gate_positions[min(gate_id,
                                                     num_gates - 1)]
            r_passed = 5

        task_completed = info.get("task_completed", False)
        r_collision = -1 if terminated and not task_completed else 0
        r_lap = 10 if terminated and task_completed else 0

        # dense progress: the xy L2 and the z L1 distance's decrease
        # (reference :164-181)
        d_prev_xy = np.linalg.norm(self.current_target[0:2]
                                   - self.previous_pos[0:2])
        d_cur_xy = np.linalg.norm(self.current_target[0:2] - obs[0][:2])
        progress_xy = d_prev_xy - d_cur_xy
        d_prev_z = np.abs(self.current_target[2] - self.previous_pos[2])
        d_cur_z = np.abs(self.current_target[2] - obs[0][2])
        progress_z = d_prev_z - d_cur_z

        self.previous_pos = obs[0, :3]
        return progress_xy + progress_z + r_passed + r_collision + r_lap
