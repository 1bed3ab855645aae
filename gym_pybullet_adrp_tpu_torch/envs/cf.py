"""Firmware-in-the-loop single-drone env (CFAviary).

Counterpart of gym_pybullet_adrp_tpu.envs.cf (``CFAviary`` :38, its
firmware window :105-178, ``_initialize_firmware`` :180, ``step`` :209,
``_process_command_queue`` :227, the ``send*Cmd`` surface :245-276, the
spaces :279-303, ``CFPIDAviary`` :305), the reference's ``CFAviary``
(reference envs/CFAviary.py:16-726) over the in-process SWIG Crazyflie
firmware: the Mellinger controller at 500 Hz (or ``controllerPid`` at
1 kHz), the sensor low-pass filters, the high-level commander (takeoff,
land, goto, fullstate, stop, notify) and the brushed-motor power
distribution. One control step runs the firmware window (``while
tick/freq < t + dt``, reference step:201-259: 20 ticks at 25 Hz) as a
Python loop of ``firmware_tick``, eager tensor ops on the env's device;
commands queue on the host like the reference's ``sendXxxCmd``.

The window launches none of the port's kernels: the JAX package runs it
as a ``lax.scan`` of plain ``jnp`` code too. State tensors carry the batch
and drone axes of envs/core.py, (1, 1, ...).

Differences from the race controller path (both per reference):
* CFAviary's power distribution converts clipped pwms straight to rpm:
  no disturbance injection (reference :244 vs MellingerControl.py:
  246-262). The [3, 2, 1, 0] motor reorder is kept: the JAX package
  adds it because the reference's CFAviary, untested there, inverts
  roll and pitch against cf2x_IROS without it.
* Action and sensor delay rings follow ``ACTION_DELAY`` and
  ``SENSOR_DELAY`` (reference :122-124, both 0 by default).
"""

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import core
from .aviary import AviaryBase, _state_space, box
from .core import AviaryConfig, CoreState
from ..control import commander as cmdr_mod
from ..control import firmware_pid as fp
from ..control import mellinger as mel
from ..models.drone import DroneParams
from ..utils.constants import (
    ACTION_DELAY, MAX_PWM, MIN_PWM, PWM2RPM_CONST, PWM2RPM_SCALE,
)
from ..utils.enums import Command, DroneModel, Physics


class FirmwareCarry(NamedTuple):
    """Everything one firmware tick reads and writes."""

    core: CoreState
    mell: mel.MellingerState        # sensors and tick bookkeeping (both)
    pid: fp.PidControllerState      # controllerPid statics (PID only)
    cmdr: cmdr_mod.CommanderState
    act_buf: torch.Tensor           # (ACTION_DELAY + 1, B, N, 4) rpm


def firmware_tick(cfg: AviaryConfig, params: DroneParams,
                  firmware_freq: int, use_pid: bool,
                  c: FirmwareCarry) -> FirmwareCarry:
    """One firmware tick (the JAX package's window body, envs/cf.py:
    125-171): physics with the queued action, the commander's setpoint,
    the sensors, the controller, pwm -> rpm into the action ring."""
    cst = core.core_step(cfg, params, c.core, c.act_buf[0])
    dtype = c.act_buf.dtype
    tick_time = c.mell.tick.to(dtype) * mel.recip32(firmware_freq)
    cs = cmdr_mod.update_setpoint(c.cmdr, tick_time)
    ms, fw, gyro_deg, acc_gs = mel.update_sensor_and_state(
        c.mell, cst.phys.pos, cst.phys.rpy, cst.phys.vel)
    ps = c.pid
    if use_pid:
        # controllerPid (reference CFAviary:401-408): the wrapper's 100 Hz
        # position / 500 Hz attitude gating
        att_due = tick_time - ms.last_att_pid_call > 0.002
        pos_due = att_due & (tick_time - ms.last_pos_pid_call > 0.01)
        ps, control = fp.controller_pid(ps, cs.setpoint, gyro_deg, fw,
                                        pos_due, att_due)
        pwms = mel.compute_pwms(control)
        ms = ms._replace(
            tick=ms.tick + 1,
            last_att_pid_call=torch.where(att_due, tick_time,
                                          ms.last_att_pid_call),
            last_pos_pid_call=torch.where(pos_due, tick_time,
                                          ms.last_pos_pid_call))
    else:
        ms, pwms = mel.step_controller(ms, cs.setpoint, fw, gyro_deg, acc_gs)
    # pwm -> rpm (reference :244) with the [3, 2, 1, 0] motor-order
    # compensation for the IROS URDF (the JAX package's fix of the
    # reference: without it the drone flips on takeoff)
    rpm = (PWM2RPM_SCALE * torch.clamp(pwms, MIN_PWM, MAX_PWM)
           + PWM2RPM_CONST).flip(-1)
    rpm = torch.where(ms.error_flag[..., None], 0.0, rpm)
    act_buf = torch.cat([c.act_buf[1:], rpm[None]], dim=0)
    return FirmwareCarry(cst, ms, ps, cs, act_buf)


def firmware_window(cfg: AviaryConfig, params: DroneParams,
                    firmware_freq: int, use_pid: bool, n_ticks: int,
                    c: FirmwareCarry) -> FirmwareCarry:
    """``n_ticks`` firmware ticks: one control step (reference
    step:201-259)."""
    for _ in range(n_ticks):
        c = firmware_tick(cfg, params, firmware_freq, use_pid, c)
    return c


class CFAviary(AviaryBase):
    """Single-drone aviary flying on firmware numerics (reference
    CFAviary)."""

    CONTROLLER = "mellinger"  # reference :21 ('pid' = 1 kHz firmware PID)

    def __init__(self, drone_model: DroneModel = DroneModel.CF2X,
                 num_drones: int = 1, neighbourhood_radius: float = np.inf,
                 initial_xyzs=None, initial_rpys=None,
                 physics: Physics = Physics.PYB, pyb_freq: int = 500,
                 ctrl_freq: int = 25, gui: bool = False,
                 record: bool = False, obstacles: bool = False,
                 user_debug_gui: bool = True,
                 output_folder: str = "results", verbose: bool = False,
                 dtype=torch.float32, device="cuda"):
        if self.CONTROLLER not in ("mellinger", "pid"):
            raise ValueError(f"unknown CONTROLLER {self.CONTROLLER!r}")
        firmware_freq = 500 if self.CONTROLLER == "mellinger" else 1000
        if pyb_freq % firmware_freq != 0:
            raise ValueError(f"pyb_freq ({pyb_freq}) must be a multiple of "
                             f"firmware_freq ({firmware_freq}) for "
                             f"CFAviary.")
        if num_drones != 1:
            raise NotImplementedError(
                "Multi-agent support for CF Aviary is not yet implemented.")
        # the base env steps at the firmware rate (reference :92)
        super().__init__(drone_model=drone_model, num_drones=num_drones,
                         neighbourhood_radius=neighbourhood_radius,
                         initial_xyzs=initial_xyzs,
                         initial_rpys=initial_rpys, physics=physics,
                         pyb_freq=pyb_freq, ctrl_freq=firmware_freq,
                         gui=gui, record=record, obstacles=obstacles,
                         user_debug_gui=user_debug_gui,
                         output_folder=output_folder, dtype=dtype,
                         device=device)
        self.firmware_freq = firmware_freq
        self.ctrl_freq = ctrl_freq
        self.ctrl_dt = 1.0 / ctrl_freq
        self.firmware_dt = 1.0 / firmware_freq
        self.PWM2RPM_SCALE = PWM2RPM_SCALE
        self.PWM2RPM_CONST = PWM2RPM_CONST
        self.MIN_PWM = MIN_PWM
        self.MAX_PWM = MAX_PWM
        self.verbose = verbose
        self._ticks_per_step = firmware_freq // ctrl_freq
        self._use_pid = self.CONTROLLER == "pid"
        self._carry = None
        self.command_queue = []
        self._initialize_firmware()

    # -- lifecycle -----------------------------------------------------------
    def _initialize_firmware(self):
        """Reset all firmware state (reference _initalize_cffirmware:
        112-185)."""
        self.states = []
        self.takeoff_sent = False
        self.tick = 0
        self.command_queue = []
        shape, dt, dev = (1, 1), self.dtype, self.device
        cst = core.core_reset(self.cfg, self.INIT_XYZS, self.INIT_RPYS, 1,
                              dt, dev)
        ms = mel.init_state(shape, dt, dev)
        ms = ms._replace(prev_rpy=torch.as_tensor(
            self.INIT_RPYS, dtype=dt, device=dev).reshape(1, 1, 3))
        # slot 0 applies next tick; extra slots emulate actuation latency
        self._carry = FirmwareCarry(
            core=cst, mell=ms, pid=fp.init_state(shape, dt, dev),
            cmdr=cmdr_mod.init_state(shape, dt, dev),
            act_buf=torch.zeros((ACTION_DELAY + 1, 1, 1, 4), dtype=dt,
                                device=dev))
        self.step_counter = 0
        self.RESET_TIME = time.time()
        return self._stateVector(), {"answer": 42}

    def reset(self, seed: Optional[int] = None,
              options: Optional[dict] = None):
        return self._initialize_firmware()

    # -- stepping ------------------------------------------------------------
    def step(self, i: int):
        """Advance one ctrl_freq step, one firmware window (reference
        :187-261); the step's one download is the state vector."""
        self._process_command_queue(i / self.ctrl_freq)
        self._carry = firmware_window(self.cfg, self.params,
                                      self.firmware_freq, self._use_pid,
                                      self._ticks_per_step, self._carry)
        # every tick advances the firmware's tick and the physics by one
        # firmware period: both counts are known on the host
        self.tick += self._ticks_per_step
        self.step_counter += self._ticks_per_step * self.PYB_STEPS_PER_CTRL
        obs = self._stateVector()
        if self.takeoff_sent:
            self.states.append([self.tick / self.firmware_freq, obs[0, 0],
                                obs[0, 1], obs[0, 2]])
        return obs, -1, False, False, {"answer": 42}

    def _process_command_queue(self, sim_time: float):
        """Pop and execute one queued command (reference :428-433)."""
        if not self.command_queue:
            return
        cmd, args = self.command_queue.pop(0)
        cid, vec = cmdr_mod.pack_command(cmd, args)
        host = np.append(vec, np.float32(sim_time)).astype(np.float32)
        dev = torch.from_numpy(host).to(self.device, self.dtype)
        c = self._carry
        ph = c.core.phys
        cmdr = cmdr_mod.process_command(
            c.cmdr, torch.full((1, 1), cid, dtype=torch.int32,
                               device=self.device),
            dev[:-1].reshape(1, 1, -1), dev[-1].reshape(1, 1), ph.pos,
            ph.vel, ph.rpy[..., 2])
        self._carry = c._replace(cmdr=cmdr)

    # -- command senders (reference :435-606) --------------------------------
    def sendFullStateCmd(self, pos, vel, acc, yaw, rpy_rate, timestep):
        self.command_queue.append(
            (Command.FULLSTATE, (pos, vel, acc, yaw, rpy_rate, timestep)))

    def sendTakeoffCmd(self, height, duration):
        self.takeoff_sent = True
        self.command_queue.append((Command.TAKEOFF, (height, duration)))

    def sendTakeoffYawCmd(self, height, duration, yaw):
        self.command_queue.append((Command.TAKEOFFYAW,
                                   (height, duration, yaw)))

    def sendTakeoffVelCmd(self, height, vel, relative):
        self.command_queue.append((Command.TAKEOFFVEL,
                                   (height, vel, relative)))

    def sendLandCmd(self, height, duration):
        self.command_queue.append((Command.LAND, (height, duration)))

    def sendLandYawCmd(self, height, duration, yaw):
        self.command_queue.append((Command.LANDYAW, (height, duration, yaw)))

    def sendLandVelCmd(self, height, vel, relative):
        self.command_queue.append((Command.LANDVEL, (height, vel, relative)))

    def sendGotoCmd(self, pos, yaw, duration_s, relative):
        self.command_queue.append((Command.GOTO,
                                   (pos, yaw, duration_s, relative)))

    def sendStopCmd(self):
        self.command_queue.append((Command.STOP, ()))

    def notifySetpointStop(self):
        self.command_queue.append((Command.NOTIFY, ()))

    # -- spaces / obs (reference :659-726) -----------------------------------
    def _actionSpace(self):
        n = self.NUM_DRONES
        return box(np.zeros((n, 4), dtype=np.float32),
                   np.full((n, 4), self.MAX_RPM, dtype=np.float32))

    def _observationSpace(self):
        return _state_space(self.NUM_DRONES, self.MAX_RPM)

    def _phys(self):
        return self._carry.core.phys

    def _stateVector(self):
        return core.state_vector(self._carry.core)[0].cpu().numpy()


class CFPIDAviary(CFAviary):
    """CFAviary flying the 1 kHz firmware PID controller (reference
    CFAviary.CONTROLLER = 'pid' variant, :21, :80, :157-159)."""

    CONTROLLER = "pid"
