"""Competition-facing controller ABC.

Capability parity with reference user_controller/BaseController.py:9-124:
per-drone construction from initial obs/info, ring buffers for learning
hooks, and an abstract ``predict`` returning either a ``(Command, args)``
tuple or a raw ndarray action.

The port's copy of the repo's agents/base.py, on the port's modules.
"""

from abc import ABC, abstractmethod
from collections import deque

import numpy as np


class BaseController(ABC):
    """Base class for race controllers."""

    def __init__(self, drone_id: int, initial_obs: np.ndarray = None,
                 initial_info: dict = None, buffer_size: int = 100,
                 verbose: bool = False):
        self.drone_id = drone_id
        self.initial_obs = initial_obs
        self.initial_info = initial_info
        self.buffer_size = buffer_size
        self.verbose = verbose
        self.reset()
        self.episode_reset()

    def reset(self):
        """Initialize/reset data buffers and counters (reference :52-58)."""
        self.action_buffer = deque([], maxlen=self.buffer_size)
        self.obs_buffer = deque([], maxlen=self.buffer_size)
        self.reward_buffer = deque([], maxlen=self.buffer_size)
        self.done_buffer = deque([], maxlen=self.buffer_size)
        self.info_buffer = deque([], maxlen=self.buffer_size)

    def episode_reset(self):
        """Reset internal state between episodes (reference :64-66)."""

    def step_learn(self, action, obs, reward, done, info):
        """Between-step learning hook (reference :70-99)."""
        self.action_buffer.append(action)
        self.obs_buffer.append(obs)
        self.reward_buffer.append(reward)
        self.done_buffer.append(done)
        self.info_buffer.append(info)

    def episode_learn(self):
        """Between-episode learning hook (reference :103-111)."""

    @abstractmethod
    def predict(self, obs, reward=None, done=None, info=None, ep_time=None):
        """Predict the next action (reference :115-124)."""
