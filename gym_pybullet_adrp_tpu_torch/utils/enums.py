"""Enumerations of the race and hover paths (copies of gym_pybullet_adrp_tpu.utils.enums).

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
    """Physics implementations; the race and hover kernels run PYB only,
    ops/dynamics.py all six."""

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


class ActionType(Enum):
    """Action types of the RL envs (envs/rl.py)."""

    MEL = "mel"
    RPM = "rpm"
    PID = "pid"
    VEL = "vel"
    ONE_D_RPM = "one_d_rpm"
    ONE_D_PID = "one_d_pid"


class ObservationType(Enum):
    """Observation types of the RL envs."""

    KIN = "kin"
    RGB = "rgb"


class ImageType(IntEnum):
    """Camera capture image type (reference utils/enums.py:30-36)."""

    RGB = 0
    DEP = 1
    SEG = 2
    BW = 3


class Command(IntEnum):
    """High-level commander commands (control/commander.py)."""

    NONE = 0
    FULLSTATE = 1
    TAKEOFF = 2
    TAKEOFFYAW = 3
    TAKEOFFVEL = 4
    LAND = 5
    LANDYAW = 6
    LANDVEL = 7
    STOP = 8
    GOTO = 9
    NOTIFY = 10
