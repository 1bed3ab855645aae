"""Crazyflie Mellinger firmware constants read by the race window.

Counterpart of gym_pybullet_adrp_tpu.control.mellinger (gains :40-64,
``lpf2p_coeffs`` :83-97, filter coefficients :199-200). The control law
itself lives in the window kernel and its plain version
(ops/race_window.py), as it does in the JAX package's Pallas kernel.
"""

import numpy as np

from ..utils.constants import (
    ACCEL_LPF_CUTOFF_FREQ, FIRMWARE_FREQ, GYRO_LPF_CUTOFF_FREQ,
)

# firmware gains (crazyflie-firmware controller_mellinger.c defaults)
GRAVITY_MAGNITUDE = 9.81  # firmware constant (differs from the sim's 9.8)
MASS = 0.032              # g_vehicleMass
MASS_THRUST = 132000.0

KP_XY = 0.4
KD_XY = 0.2
KI_XY = 0.05
I_RANGE_XY = 2.0

KP_Z = 1.25
KD_Z = 0.4
KI_Z = 0.05
I_RANGE_Z = 0.4

KR_XY = 70000.0
KW_XY = 20000.0
KI_M_XY = 0.0
I_RANGE_M_XY = 1.0

KR_Z = 60000.0
KW_Z = 12000.0
KI_M_Z = 500.0
I_RANGE_M_Z = 1500.0

KD_OMEGA_RP = 200.0


def lpf2p_coeffs(sample_freq: float, cutoff_freq: float):
    """Static biquad coefficients (firmware lpf2pInit/lpf2pSetCutoffFreq),
    as plain Python floats."""
    fr = sample_freq / cutoff_freq
    ohm = np.tan(np.pi / fr)
    c = 1.0 + 2.0 * np.cos(np.pi / 4.0) * ohm + ohm * ohm
    b0 = ohm * ohm / c
    b1 = 2.0 * b0
    b2 = b0
    a1 = 2.0 * (ohm * ohm - 1.0) / c
    a2 = (1.0 - 2.0 * np.cos(np.pi / 4.0) * ohm + ohm * ohm) / c
    return float(b0), float(b1), float(b2), float(a1), float(a2)


# filter-assignment quirk preserved: the reference initializes the *accel*
# LPF with the GYRO cutoff and vice versa (MellingerControl.py:113-117)
_ACC_LPF_COEFFS = lpf2p_coeffs(FIRMWARE_FREQ, GYRO_LPF_CUTOFF_FREQ)
_GYRO_LPF_COEFFS = lpf2p_coeffs(FIRMWARE_FREQ, ACCEL_LPF_CUTOFF_FREQ)
