"""Scripted racer for the twogates track (reference
user_controller/HardCodedControllerTwoGates.py): a 3-waypoint spline through
the two gates flown as a fast 1 s FULLSTATE stream after takeoff.

Mirrors the reference's hand-tuned sequence including its aggressiveness:
the 1 s dash outruns the Mellinger's tracking envelope, so (as in the
reference, which labels it "crude... susceptible to noise") it typically
clears gate 1 and lands; agents/hardcoded.py is the validated full-track
controller.

The port's copy of the repo's agents/hardcoded_twogates.py, on the port's modules.
"""

import numpy as np
from scipy import interpolate

from .base import BaseController
from ..utils.constants import CTRL_DT, CTRL_FREQ, Z_HIGH, Z_LOW
from ..utils.enums import Command


class HardCodedControllerTwoGates(BaseController):
    """Two-gate scripted controller (reference :14-154)."""

    def __init__(self, drone_id, initial_obs, initial_info,
                 buffer_size: int = 100, verbose: bool = False):
        super().__init__(drone_id, initial_obs, initial_info, buffer_size, verbose)
        self.CTRL_TIMESTEP = CTRL_DT
        self.CTRL_FREQ = CTRL_FREQ
        self.initial_obs = initial_obs
        self.delay = (initial_info or {}).get("delay", 0)
        self.NOMINAL_GATES = initial_obs[12:28].reshape((4, 4))

        gates = self.NOMINAL_GATES
        waypoints = np.array(
            [
                [initial_obs[0], initial_obs[1], 0.3],
                [gates[0][0], gates[0][1] + 0.3, Z_LOW],
                [gates[1][0], gates[1][1], Z_HIGH + 0.1],
            ]
        )
        tck, _ = interpolate.splprep(
            [waypoints[:, 0], waypoints[:, 1], waypoints[:, 2]], s=0.1, k=2
        )
        self.waypoints = waypoints
        duration = 1
        t = np.linspace(0, 1, int(duration * self.CTRL_FREQ))
        self.ref_x, self.ref_y, self.ref_z = interpolate.splev(t, tck)
        assert max(self.ref_z) < 2.5, "Drone must stay below the ceiling"

        self._take_off = False
        self._setpoint_land = False
        self._land = False

    def predict(self, obs, reward=None, done=None, info=None, ep_time=None):
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


Controller = HardCodedControllerTwoGates
