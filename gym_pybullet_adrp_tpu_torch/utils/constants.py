"""Global constants of the port (from gym_pybullet_adrp_tpu.utils.constants).

Plain Python floats: combined with float32 tensors they act as float32
scalars, as JAX's weakly typed Python scalars do in the reference.
"""

import math

# math
RAD_TO_DEG = 180.0 / math.pi
DEG_TO_RAD = math.pi / 180.0

# gravity of the simulator (the firmware uses 9.81, control/mellinger.py)
G = 9.8

# lsy-drone-racing geometry
VISIBILITY_RANGE = 0.45

# crazyflie firmware
FIRMWARE_FREQ = 500
CTRL_FREQ = 25
GYRO_LPF_CUTOFF_FREQ = 80.0
ACCEL_LPF_CUTOFF_FREQ = 30.0

# race gate geometry, from the portal/low_portal/obstacle URDFs
GATE_Z_TALL = 1.0
GATE_Z_LOW = 0.525
GATE_RAY_HALF_LEN = 0.1875
GATE_OPENING_HALF = 0.225  # beam center offset from gate center
GATE_BEAM_HALF = 0.025     # beam half thickness
GATE_EDGE_HALF_LEN = 0.25  # beams are 0.5 m long
GATE_SUPPORT_RADIUS = 0.05
GATE_SUPPORT_CENTER_DZ = -0.6
GATE_SUPPORT_HALF_LEN = 0.4
OBSTACLE_RADIUS = 0.05
OBSTACLE_HALF_LEN = 0.4    # 0.8 m cylinder centered at the obstacle z
