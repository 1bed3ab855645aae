"""Trivial constant-waypoint agent (reference user_controller/HoverController.py).

The port's copy of the repo's agents/hover.py, on the port's modules.
"""

import numpy as np

from .base import BaseController


class HoverController(BaseController):
    """Command a fixed hover waypoint per drone (reference :25)."""

    def predict(self, obs, reward=None, done=None, info=None, ep_time=None):
        return np.array([1.5, 0.5, 1 + self.drone_id, 0])


Controller = HoverController
