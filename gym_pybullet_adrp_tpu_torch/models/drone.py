"""Drone constants the race path reads.

Counterpart of gym_pybullet_adrp_tpu.models.drone: the CF2X registry
scalars the race kernels consume (transcribed there from the reference
URDF) and the legacy cf2x mass/inertia that the race env's inertia
randomization starts from. The other drone models and the derived
``DroneParams`` properties belong to the hover slice.
"""

from ..utils.enums import DroneModel

_REGISTRY = {
    DroneModel.CF2X: dict(
        arm=0.0397, kf=3.16e-10, km=7.94e-12,
        collision_h=0.025, collision_z_offset=0.0,
    ),
}

# mass/inertia of the plain (non-IROS) cf2x urdf: the base of the race
# env's per-drone inertia randomization
CF2X_LEGACY = dict(mass=0.027, J=(1.4e-5, 1.4e-5, 2.17e-5))
