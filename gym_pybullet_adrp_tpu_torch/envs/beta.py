"""CTBR-command env (BetaAviary).

Counterpart of gym_pybullet_adrp_tpu.envs.beta (the RC constants :40-48,
``ctbr2beta`` :50, ``beta2ctbr`` :65, ``beta_motors_to_rpm`` :74,
``BetaAviary`` :82 with its step :121-164). The reference's
``BetaAviary`` (reference envs/BetaAviary.py) spawns one Betaflight SITL
process per drone and exchanges FDM/RC/PWM packets over UDP every control
step; here the collective-thrust-body-rates pathway is the in-graph rate
controller of control/ctbr.py, eager tensor ops on the env's device, and
the reference's unit conversions are kept:

* ``ctbr2beta`` (reference :176-188): thrust and body rates -> RC
  channels 1000-2000 with the ENU->NED yaw sign flip, clipping, and the RC
  packet's integer rounding (``torch.round`` rounds half to even, as
  ``jnp.round``);
* neutral RC before ``TRAJ_TIME`` (reference :139-150);
* the SITL's normalized [0, 1] motor outputs -> ``_preprocessAction``'s
  Betaflight motor remap ``[2, 1, 3, 0]`` and ``rpm = sqrt(MAX_THRUST / 4
  / KF * u)`` (reference :239-267).

The operations are the JAX package's, each rounded, as its functions
round them run eagerly (under ``jit`` XLA folds the constant chains and
fuses multiply-adds, which moves an RC channel whose value lies within an
ulp of a half). The step launches none of the port's kernels.
"""

import time
from typing import Optional

import numpy as np
import torch

from . import core
from .aviary import AviaryBase, _state_space, box
from ..control import ctbr
from ..ops import dynamics
from ..utils.device_consts import const
from ..utils.enums import DroneModel, Physics

# reference BetaAviary RC-packing constants (:94-95, :176-182)
ARM_TIME = 1.0
TRAJ_TIME = 1.5
MIN_CHANNEL = 1000.0
MAX_CHANNEL = 2000.0
MAX_RATE = 360.0          # deg/s at full RC deflection
BETA_MAX_THRUST = 40.9    # specific thrust (m/s^2) at full throttle
_MID = (MAX_CHANNEL + MIN_CHANNEL) / 2.0
_D = (MAX_CHANNEL - MIN_CHANNEL) / 2.0
_DEG = 180.0 / np.pi
# Betaflight motor remap of _preprocessAction
BETA_MOTOR_ORDER = (2, 1, 3, 0)


def ctbr2beta(thrust, roll, pitch, yaw):
    """CTBR -> RC channels (thro, (roll, pitch, yaw)), 1000-2000 rounded
    (reference BetaAviary.ctbr2beta:176-188 and the RC packet's round(),
    :150-157): rates in rad/s map to +-MAX_RATE deg/s full scale with the
    ENU->NED yaw flip; thrust in m/s^2 maps to [MIN, MAX] over [0,
    BETA_MAX_THRUST]."""
    thro = thrust / BETA_MAX_THRUST * _D * 2.0 + MIN_CHANNEL
    rates = (torch.stack([roll, pitch, -yaw], dim=-1) * _DEG / MAX_RATE
             * _D + _MID)
    thro = torch.clamp(thro, MIN_CHANNEL, MAX_CHANNEL)
    rates = torch.clamp(rates, MIN_CHANNEL, MAX_CHANNEL)
    return torch.round(thro), torch.round(rates)


def beta2ctbr(thro, rates_ch):
    """RC channels -> (specific thrust m/s^2, body rates rad/s): the SITL
    side's decode (the inverse of ``ctbr2beta``, undoing the yaw flip)."""
    thrust = (thro - MIN_CHANNEL) / (2.0 * _D) * BETA_MAX_THRUST
    rates = (rates_ch - _MID) / _D * MAX_RATE / _DEG
    rates = rates * const((1.0, 1.0, -1.0), rates.dtype, rates.device)
    return thrust, rates


def beta_motors_to_rpm(u, max_thrust, kf):
    """Normalized SITL motor outputs -> rpm (reference _preprocessAction:
    239-267): the motor remap ``[2, 1, 3, 0]``, then ``rpm = sqrt(
    MAX_THRUST / 4 / KF * u)``."""
    remapped = u.index_select(-1, const(BETA_MOTOR_ORDER, torch.int64,
                                        u.device))
    return torch.sqrt(max_thrust[..., None] / 4.0 / kf[..., None]
                      * remapped)


class BetaAviary(AviaryBase):
    """Multi-drone env with a CTBR (rate-command) action pathway."""

    def __init__(self, drone_model: DroneModel = DroneModel.CF2X,
                 num_drones: int = 1, neighbourhood_radius: float = np.inf,
                 initial_xyzs=None, initial_rpys=None,
                 physics: Physics = Physics.PYB, pyb_freq: int = 500,
                 ctrl_freq: int = 25, gui: bool = False,
                 record: bool = False, obstacles: bool = False,
                 user_debug_gui: bool = True,
                 output_folder: str = "results", udp_ip: str = None,
                 dtype=torch.float32, device="cuda"):
        # ``udp_ip`` is accepted for the reference's API; no sockets here
        super().__init__(drone_model=drone_model, num_drones=num_drones,
                         neighbourhood_radius=neighbourhood_radius,
                         initial_xyzs=initial_xyzs,
                         initial_rpys=initial_rpys, physics=physics,
                         pyb_freq=pyb_freq, ctrl_freq=ctrl_freq, gui=gui,
                         record=record, obstacles=obstacles,
                         user_debug_gui=user_debug_gui,
                         output_folder=output_folder, dtype=dtype,
                         device=device)
        self._state = None
        self.beta_action = np.zeros((num_drones, 4))

    def _actionSpace(self):
        # CTBR: thrust (m/s^2 specific), body rates (rad/s)
        n = self.NUM_DRONES
        lo = np.tile(np.array([0.0, -6 * np.pi, -6 * np.pi, -2 * np.pi],
                              dtype=np.float32), (n, 1))
        hi = np.tile(np.array([4 * 9.8, 6 * np.pi, 6 * np.pi, 2 * np.pi],
                              dtype=np.float32), (n, 1))
        return box(lo, hi)

    def _observationSpace(self):
        return _state_space(self.NUM_DRONES, self.MAX_RPM)

    def reset(self, seed: Optional[int] = None,
              options: Optional[dict] = None):
        self._state = core.core_reset(self.cfg, self.INIT_XYZS,
                                      self.INIT_RPYS, 1, self.dtype,
                                      self.device)
        self.step_counter = 0
        self.RESET_TIME = time.time()
        self.beta_action = np.zeros((self.NUM_DRONES, 4))
        return self._stateVector(), {"answer": 42}

    def step(self, action, i: int = 0):
        """``action`` (N, 4) CTBR [thrust, p, q, r] (reference
        step:110-171); ``i`` is the control-step index: t = i / CTRL_FREQ
        gates the RC neutral phase like the reference's TRAJ_TIME."""
        a = np.asarray(action, dtype=np.float32).reshape(self.NUM_DRONES, 4)
        # t as the JAX package forms it: the float64 quotient in float32
        t = float(np.float32(i / self.CTRL_FREQ))
        self._state = beta_step(self.cfg, self.params, self._state,
                                torch.from_numpy(a).to(self.device,
                                                       self.dtype)[None],
                                t > TRAJ_TIME)
        self.step_counter += self.PYB_STEPS_PER_CTRL
        self.beta_action = a.astype(np.float64)
        return self._stateVector(), -1, False, False, {"answer": 42}

    def _stateVector(self):
        return core.state_vector(self._state)[0].cpu().numpy()


def beta_step(cfg: core.AviaryConfig, params, state: core.CoreState,
              ctbr_action, live: bool) -> core.CoreState:
    """One env step of B envs through the Betaflight chain (the JAX
    package's jitted ``_step``, envs/beta.py:121-164): CTBR (B, N, 4) ->
    RC channels (quantized; neutral unless ``live``) -> the SITL's decode
    and rate loop -> normalized motor outputs -> remap and rpm, once per
    physics substep."""
    thro, rates_ch = ctbr2beta(ctbr_action[..., 0], ctbr_action[..., 1],
                               ctbr_action[..., 2], ctbr_action[..., 3])
    if not live:
        # RC packet (reference step:139-157): neutral sticks until the
        # trajectory starts
        thro = torch.full_like(thro, MIN_CHANNEL)
        rates_ch = torch.full_like(rates_ch, _MID)
    thrust_sp, rate_sp = beta2ctbr(thro, rates_ch)
    dt = cfg.pyb_timestep
    for _ in range(cfg.steps_per_ctrl):
        u = ctbr.betaflight_motor_outputs(params, thrust_sp, rate_sp,
                                          state.phys.omega)
        rpm = beta_motors_to_rpm(u, params.max_thrust, params.kf)
        phys = dynamics.substep(params, state.phys, rpm,
                                state.last_clipped_action, dt,
                                cfg.drone_model, cfg.physics)
        state = core.CoreState(phys=phys, last_clipped_action=rpm,
                               step_counter=state.step_counter + 1)
    return state
