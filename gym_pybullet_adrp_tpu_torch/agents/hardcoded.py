"""Scripted racer: spline through hand-placed waypoints around the gates.

Capability parity with reference user_controller/HardCodedController.py:
takeoff, stream FULLSTATE setpoints along a fitted spline, then
NOTIFY -> LAND. Waypoint placement mirrors the reference's hand-tuned route
for the getting_started track (reference :63-110).

The port's copy of the repo's agents/hardcoded.py, on the port's modules.
"""

import numpy as np
from scipy import interpolate

from .base import BaseController
from ..utils.constants import CTRL_DT, CTRL_FREQ, Z_HIGH, Z_LOW
from ..utils.enums import Command


class HardCodedController(BaseController):
    """Template scripted controller (reference HardCodedController:14-190)."""

    def __init__(self, drone_id, initial_obs, initial_info,
                 buffer_size: int = 100, verbose: bool = False):
        super().__init__(drone_id, initial_obs, initial_info, buffer_size, verbose)
        self.CTRL_TIMESTEP = CTRL_DT
        self.CTRL_FREQ = CTRL_FREQ
        self.initial_obs = initial_obs
        self.delay = (initial_info or {}).get("delay", 0)

        # a-priori track knowledge from the initial observation layout
        self.NOMINAL_GATES = initial_obs[12:28].reshape((4, 4))
        self.NOMINAL_OBSTACLES = initial_obs[32:44].reshape((4, 3))

        self.reset()
        self.episode_reset()

        gates = self.NOMINAL_GATES
        z_low, z_high = Z_LOW, Z_HIGH
        waypoints = [
            [initial_obs[0], initial_obs[1], 0.3],
            [1, 0, z_low],
            [gates[0][0] + 0.2, gates[0][1] + 0.1, z_low],
            [gates[0][0] + 0.1, gates[0][1], z_low],
            [gates[0][0] - 0.1, gates[0][1], z_low],
            [
                (gates[0][0] + gates[1][0]) / 2 - 0.7,
                (gates[0][1] + gates[1][1]) / 2 - 0.3,
                (z_low + z_high) / 2,
            ],
            [
                (gates[0][0] + gates[1][0]) / 2 - 0.5,
                (gates[0][1] + gates[1][1]) / 2 - 0.6,
                (z_low + z_high) / 2,
            ],
            [gates[1][0] - 0.3, gates[1][1] - 0.2, z_high],
            [gates[1][0] + 0.2, gates[1][1] + 0.2, z_high],
            [gates[2][0], gates[2][1] - 0.4, z_low],
            [gates[2][0], gates[2][1] + 0.2, z_low],
            [gates[2][0], gates[2][1] + 0.2, z_high + 0.2],
            [gates[3][0], gates[3][1] + 0.1, z_high],
            [gates[3][0], gates[3][1] - 0.1, z_high + 0.1],
            [-0.5, -1.2, z_high],
            [-0.5, -1.4, z_high],
        ]
        waypoints = np.array(waypoints)
        tck, _ = interpolate.splprep(
            [waypoints[:, 0], waypoints[:, 1], waypoints[:, 2]], s=0.1
        )
        self.waypoints = waypoints
        duration = 12
        t = np.linspace(0, 1, int(duration * self.CTRL_FREQ))
        self.ref_x, self.ref_y, self.ref_z = interpolate.splev(t, tck)
        assert max(self.ref_z) < 2.5, "Drone must stay below the ceiling"

        self._take_off = False
        self._setpoint_land = False
        self._land = False

    def predict(self, obs, reward=None, done=None, info=None, ep_time=None):
        """Takeoff -> spline FULLSTATE stream -> NOTIFY -> LAND state machine
        (reference predict:127-190)."""
        iteration = int(ep_time * self.CTRL_FREQ)

        if not self._take_off:
            self._take_off = True
            return Command.TAKEOFF, [0.3, 2]

        step = iteration - (2 + self.delay) * self.CTRL_FREQ
        step = int(np.clip(step, 0, len(self.ref_x)))
        if step < len(self.ref_x):
            return Command.FULLSTATE, [
                np.array([self.ref_x[step], self.ref_y[step], self.ref_z[step]]),
                np.zeros(3),
                np.ones(3) * 0.5,
                0.0,
                np.zeros(3),
                ep_time,
            ]
        if not self._setpoint_land:
            self._setpoint_land = True
            return Command.NOTIFY, [ep_time]
        if not self._land:
            self._land = True
            return Command.LAND, [0.0, 2.0]
        return Command.NONE, []


Controller = HardCodedController
