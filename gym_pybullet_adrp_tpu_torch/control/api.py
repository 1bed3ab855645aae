"""Object-style controller API over the function controllers.

Counterpart of gym_pybullet_adrp_tpu.control.api (``BaseControl`` :21,
``DSLPIDControl`` :92, ``CTBRControl`` :145, ``MellingerControl`` :180
with its command queue and ``process_command_queue`` :281). Users of the
reference instantiate stateful controller objects (reference
control/BaseControl.py:55-224) and call ``computeControl[FromState]`` per
tick with numpy arrays; these wrappers keep that surface and run the math
of control/dslpid.py, control/ctbr.py and control/mellinger.py on
``device`` (the card unless the caller asks for the CPU), with one upload
of the call's inputs and one download of its outputs. For batched use,
call the function modules directly.
"""

import numpy as np
import torch

from . import commander as cmdr_mod
from . import ctbr as ctbr_mod
from . import dslpid, mellinger as mel
from ..models.drone import drone_params
from ..utils.enums import Command, DroneModel


class BaseControl:
    """Controller base surface (reference BaseControl.py:15-224)."""

    def __init__(self, drone_model: DroneModel, g: float = 9.8,
                 device="cuda"):
        self.DRONE_MODEL = drone_model
        self.device = torch.device(device)
        self.params = drone_params(drone_model, device=self.device)
        self.GRAVITY = g * float(self.params.mass)
        self.KF = float(self.params.kf)
        self.KM = float(self.params.km)
        self.reset()

    def reset(self):
        self.control_counter = 0

    def _upload(self, *arrays):
        """The call's numpy inputs as float32 tensors on the device, with
        one copy."""
        flat = [np.asarray(a, dtype=np.float32).reshape(-1) for a in arrays]
        packed = torch.from_numpy(np.concatenate(flat)).to(self.device)
        return torch.split(packed, [len(a) for a in flat])

    def computeControlFromState(self, control_timestep, state, target_pos,
                                target_rpy=np.zeros(3),
                                target_vel=np.zeros(3),
                                target_rpy_rates=np.zeros(3)):
        """Compute control from a 20-dim state vector (reference :55-95)."""
        return self.computeControl(
            control_timestep=control_timestep,
            cur_pos=np.asarray(state[0:3]),
            cur_quat=np.asarray(state[3:7]),
            cur_vel=np.asarray(state[10:13]),
            cur_ang_vel=np.asarray(state[13:16]),
            target_pos=np.asarray(target_pos),
            target_rpy=np.asarray(target_rpy),
            target_vel=np.asarray(target_vel),
            target_rpy_rates=np.asarray(target_rpy_rates),
        )

    def computeControl(self, **kwargs):
        raise NotImplementedError

    def setPIDCoefficients(self, p_coeff_pos=None, i_coeff_pos=None,
                           d_coeff_pos=None, p_coeff_att=None,
                           i_coeff_att=None, d_coeff_att=None):
        """Override PID gains (reference :141-183)."""
        attrs = ["P_COEFF_FOR", "I_COEFF_FOR", "D_COEFF_FOR",
                 "P_COEFF_TOR", "I_COEFF_TOR", "D_COEFF_TOR"]
        if not all(hasattr(self, a) for a in attrs):
            raise AttributeError(
                "[ERROR] setPIDCoefficients() on a non-PID controller")
        for attr, val in zip(attrs, [p_coeff_pos, i_coeff_pos, d_coeff_pos,
                                     p_coeff_att, i_coeff_att, d_coeff_att]):
            if val is not None:
                setattr(self, attr, np.asarray(val))

    def _getURDFParameter(self, parameter_name: str):
        """Parameter lookup by reference URDF attribute name (:185-224)."""
        p = self.params
        J = p.J.tolist()
        drag = p.drag_coeff.tolist()
        mapping = {
            "m": float(p.mass), "arm": float(p.arm), "kf": float(p.kf),
            "km": float(p.km), "thrust2weight": float(p.thrust2weight),
            "max_speed_kmh": float(p.max_speed_kmh),
            "gnd_eff_coeff": float(p.gnd_eff_coeff),
            "prop_radius": float(p.prop_radius),
            "drag_coeff_xy": drag[0], "drag_coeff_z": drag[2],
            "dw_coeff_1": float(p.dw_coeff_1),
            "dw_coeff_2": float(p.dw_coeff_2),
            "dw_coeff_3": float(p.dw_coeff_3),
            "ixx": J[0], "iyy": J[1], "izz": J[2],
        }
        return mapping[parameter_name]


class DSLPIDControl(BaseControl):
    """Stateful DSL PID wrapper (reference control/DSLPIDControl.py) over
    ``dslpid.compute_control``."""

    def __init__(self, drone_model: DroneModel, g: float = 9.8,
                 device="cuda"):
        super().__init__(drone_model, g, device)
        self.P_COEFF_FOR = np.array(dslpid.P_FOR)
        self.I_COEFF_FOR = np.array(dslpid.I_FOR)
        self.D_COEFF_FOR = np.array(dslpid.D_FOR)
        self.P_COEFF_TOR = np.array(dslpid.P_TOR)
        self.I_COEFF_TOR = np.array(dslpid.I_TOR)
        self.D_COEFF_TOR = np.array(dslpid.D_TOR)
        self.PWM2RPM_SCALE = dslpid.PWM2RPM_SCALE
        self.PWM2RPM_CONST = dslpid.PWM2RPM_CONST
        self.MIN_PWM = dslpid.MIN_PWM
        self.MAX_PWM = dslpid.MAX_PWM

    def reset(self):
        super().reset()
        self.ctl_state = dslpid.init_state((), device=self.device)
        self.last_rpy = np.zeros(3)
        self.last_pos_e = np.zeros(3)
        self.integral_pos_e = np.zeros(3)
        self.last_rpy_e = np.zeros(3)
        self.integral_rpy_e = np.zeros(3)

    def computeControl(self, control_timestep, cur_pos, cur_quat, cur_vel,
                       cur_ang_vel, target_pos, target_rpy=np.zeros(3),
                       target_vel=np.zeros(3),
                       target_rpy_rates=np.zeros(3)):
        """(rpm (4,), position error (3,), yaw error) of one step."""
        self.control_counter += 1
        p, q, v, tp, tr, tv, trr = self._upload(
            cur_pos, cur_quat, cur_vel, target_pos, target_rpy, target_vel,
            target_rpy_rates)
        dt = float(np.float32(control_timestep))
        rpm, self.ctl_state, pos_e, yaw_e = dslpid.compute_control(
            self.params, self.ctl_state, dt, p, q, v, tp, tr, tv, trr,
            model=self.DRONE_MODEL)
        st = self.ctl_state
        out = torch.cat([rpm, pos_e, yaw_e[None], st.integral_pos_e,
                         st.integral_rpy_e, st.last_rpy]).cpu().numpy()
        self.integral_pos_e = out[8:11]
        self.integral_rpy_e = out[11:14]
        self.last_rpy = out[14:17]
        return out[0:4], out[4:7], float(out[7])


class CTBRControl(BaseControl):
    """Collective-thrust-body-rates controller (reference
    control/CTBRControl.py) over ``ctbr.position_to_ctbr``."""

    def computeControl(self, control_timestep, cur_pos, cur_quat, cur_vel,
                       cur_ang_vel, target_pos, target_rpy=np.zeros(3),
                       target_vel=np.zeros(3),
                       target_rpy_rates=np.zeros(3)):
        """(thrust, roll rate, pitch rate, yaw rate) as floats."""
        p, q, v, tp, tv = self._upload(cur_pos, cur_quat, cur_vel,
                                       target_pos, target_vel)
        thrust, rates = ctbr_mod.position_to_ctbr(p, q, v, tp, tv)
        out = torch.cat([thrust[None], rates]).cpu().numpy()
        return float(out[0]), float(out[1]), float(out[2]), float(out[3])

    # the base's computeControlFromState: the reference reads the state
    # quat as wxyz (CTBRControl.py:92); position_to_ctbr takes the
    # framework's xyzw, so the state's quat passes through unchanged


class MellingerControl(BaseControl):
    """Stateful Mellinger wrapper with the subprocess controller's surface
    (reference control/MellingerControl.py:64-262), in process. Commands
    queue like the reference's ``sendXxxCmd`` and execute on
    ``process_command_queue`` with the last kinematics seen by
    ``computeControl``/``reset``."""

    def __init__(self, drone_id: int, drone_model: DroneModel,
                 g: float = 9.8, device="cuda"):
        # set before super().__init__, which calls reset()
        self.drone_id = drone_id
        self.device = torch.device(device)
        super().__init__(drone_model, g, device)

    def reset(self, init_obs=None):
        super().reset()
        self.mell = mel.init_state((), device=self.device)
        self.cmdr = cmdr_mod.init_state((), device=self.device)
        self.command_queue = []
        self._last_pos = np.zeros(3)
        self._last_vel = np.zeros(3)
        self._last_yaw = 0.0
        self._tick = 0
        if init_obs is not None:
            drone = np.asarray(init_obs)[self.drone_id, :12]
            self._last_pos = drone[0:3]
            self._last_vel = drone[6:9]
            self._last_yaw = float(drone[5])
            rpy, vel = self._upload(drone[3:6], drone[6:9])
            self.mell = self.mell._replace(prev_rpy=rpy, prev_vel=vel)

    def computeControl(self, control_timestep, cur_pos, cur_rpy, cur_vel,
                       cur_ang_vel, target_pos, target_rpy=np.zeros(3),
                       target_vel=np.zeros(3),
                       target_rpy_rates=np.zeros(3)):
        """One 500 Hz tick -> rpm (4,); ``target_pos`` carries the thrust
        disturbance, as in the reference (MellingerControl.py:202-203)."""
        self._last_pos = np.asarray(cur_pos, dtype=float)
        self._last_vel = np.asarray(cur_vel, dtype=float)
        self._last_yaw = float(np.asarray(cur_rpy)[2])
        dist = np.asarray(target_pos, dtype=np.float32).reshape(-1)
        if dist.shape[0] == 3:
            dist = np.pad(dist, (0, 1))
        pos, rpy, vel, disturbance = self._upload(cur_pos, cur_rpy, cur_vel,
                                                  dist)
        # the firmware's tick is counted on the host too, so the tick time
        # needs no download
        self.cmdr = cmdr_mod.update_setpoint(self.cmdr, self._tick / 500.0)
        self.mell, rpm = mel.compute_control(
            self.mell, self.cmdr.setpoint, pos, rpy, vel, disturbance,
            kf=self.KF)
        self._tick += 1
        return rpm.cpu().numpy()

    # -- command surface (reference :491-699) -------------------------------
    def sendFullStateCmd(self, pos, vel, acc, yaw, rpy_rate, timestep):
        self.command_queue.append(
            (Command.FULLSTATE, (pos, vel, acc, yaw, rpy_rate, timestep)))

    def sendTakeoffCmd(self, height, duration):
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

    def process_command_queue(self, sim_time):
        """Pop and execute the next queued command (reference
        process_command_queue:292-303)."""
        if not self.command_queue:
            return
        cmd, args = self.command_queue.pop(0)
        cid, vec = cmdr_mod.pack_command(cmd, args)
        vec, t, pos, vel, yaw = self._upload(
            vec, [sim_time], self._last_pos, self._last_vel,
            [self._last_yaw])
        self.cmdr = cmdr_mod.process_command(
            self.cmdr, torch.tensor(cid, dtype=torch.int32,
                                    device=self.device),
            vec, t[0], pos, vel, yaw[0])
