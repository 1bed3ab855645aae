"""Enumerations the race path reads (copies of gym_pybullet_adrp_tpu.utils.enums).

Copied rather than imported: importing any ``gym_pybullet_adrp_tpu``
module runs that package's ``__init__``, which needs gymnasium.
"""

from enum import Enum, IntEnum


class DroneModel(Enum):
    """Drone models (parameter sets live in models/drone.py)."""

    CF2X = "cf2x_IROS"
    CF2P = "cf2p"
    RACE = "racer"


class Physics(IntEnum):
    """Physics implementations; the race kernels run PYB only."""

    PYB = 0
    DYN = 1
    PYB_GND = 2
    PYB_DRAG = 3
    PYB_DW = 4
    PYB_GND_DRAG_DW = 5


class RaceMode(IntEnum):
    """Race mode: collision behaviour + obs-space structure."""

    COMPARE = 0
    COMPETE = 1
