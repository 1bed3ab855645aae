"""Gymnasium-API aviary classes over the batched env core.

Counterpart of gym_pybullet_adrp_tpu/envs/aviary.py (``JaxAviaryBase``
:30 as ``AviaryBase``, ``CtrlAviary`` :198, ``VelocityAviary`` :265,
``BaseRLAviary`` :327, ``HoverAviary`` :476, ``MultiHoverAviary`` :489):
the reference's single-env classes, each a batch of one env of
envs/core.py or envs/rl.py on ``device``, converted to and from numpy at
the API boundary with one download a step.

The card's machine has no gymnasium, so no module here imports it when it
is imported. The classes carry the gymnasium API by its methods and
attributes (``reset``, ``step``, ``close``, ``render``, ``metadata``);
``action_space`` and ``observation_space`` import ``gymnasium.spaces``
when first read. ``gym_class`` makes the ``gymnasium.Env`` subclass of a
class, which ``gym_pybullet_adrp_tpu_torch.register()`` registers under
the reference's ids.

The camera (JAX :148-197, :419-445): ``_getDroneImages`` renders a
drone's POV frame with the ray-casting renderer (ops/render.py) on the
env's device, and ``ObservationType.RGB`` observes every drone's frame
(one batched render), captured at the reference's 24 frames a second and
cached between captures.
"""

import time
from typing import Optional

import numpy as np
import torch

from . import core, rl
from .core import AviaryConfig
from ..control import dslpid
from ..models.drone import drone_params
from ..ops import render
from ..utils.enums import ActionType, DroneModel, ObservationType, Physics

def gym_class(cls):
    """A ``gymnasium.Env`` subclass of ``cls`` (imports gymnasium)."""
    import gymnasium

    return type(cls.__name__, (cls, gymnasium.Env),
                {"__module__": cls.__module__, "__doc__": cls.__doc__})


class LazySpaces:
    """``action_space``/``observation_space`` built by ``_actionSpace``/
    ``_observationSpace`` at first read, when gymnasium is imported, and
    kept; ``unwrapped`` is the env itself, as ``gymnasium.Env``'s (the
    wrappers of utils/wrapper.py read it)."""

    @property
    def unwrapped(self):
        return self

    def _lazy(self, key, build):
        cache = self.__dict__.setdefault("_space_cache", {})
        if key not in cache:
            cache[key] = build()
        return cache[key]

    @property
    def action_space(self):
        return self._lazy("action", self._actionSpace)

    @property
    def observation_space(self):
        return self._lazy("observation", self._observationSpace)


def box(low, high, dtype=np.float32, shape=None):
    from gymnasium import spaces

    return spaces.Box(low=low, high=high, shape=shape, dtype=dtype)


class AviaryBase(LazySpaces):
    """Params, initial poses and bookkeeping shared by the aviaries
    (reference BaseAviary.__init__:25-40). The PyBullet-only options (gui,
    record, user_debug_gui, vision_attributes, output_folder) are
    accepted and kept, as the JAX package does."""

    metadata = {"render_modes": []}

    def __init__(self, drone_model: DroneModel = DroneModel.CF2X,
                 num_drones: int = 1, neighbourhood_radius: float = np.inf,
                 initial_xyzs=None, initial_rpys=None,
                 physics: Physics = Physics.PYB, pyb_freq: int = 240,
                 ctrl_freq: int = 240, gui: bool = False,
                 record: bool = False, obstacles: bool = False,
                 user_debug_gui: bool = True,
                 vision_attributes: bool = False,
                 output_folder: str = "results", dtype=torch.float32,
                 device="cuda"):
        self.cfg = AviaryConfig(drone_model=drone_model,
                                num_drones=num_drones, physics=physics,
                                pyb_freq=pyb_freq, ctrl_freq=ctrl_freq,
                                neighbourhood_radius=neighbourhood_radius)
        self.dtype = dtype
        self.device = torch.device(device)
        self.params = drone_params(drone_model, dtype=dtype,
                                   device=self.device)
        # constants under the reference's names (BaseAviary.py:74-128)
        self.G = 9.8
        self.NUM_DRONES = num_drones
        self.DRONE_MODEL = drone_model
        self.PHYSICS = physics
        self.CTRL_FREQ = ctrl_freq
        self.PYB_FREQ = pyb_freq
        self.PYB_STEPS_PER_CTRL = self.cfg.steps_per_ctrl
        self.CTRL_TIMESTEP = self.cfg.ctrl_timestep
        self.PYB_TIMESTEP = self.cfg.pyb_timestep
        self.GUI = gui
        self.RECORD = record
        self.OBSTACLES = obstacles
        self.OUTPUT_FOLDER = output_folder
        p = self.params
        self.M = float(p.mass)
        self.L = float(p.arm)
        self.KF = float(p.kf)
        self.KM = float(p.km)
        self.GRAVITY = float(p.gravity)
        self.HOVER_RPM = float(p.hover_rpm)
        self.MAX_RPM = float(p.max_rpm)
        self.MAX_THRUST = float(p.max_thrust)
        self.MAX_SPEED_KMH = float(p.max_speed_kmh)
        self.SPEED_LIMIT = float(p.speed_limit)
        self.COLLISION_H = float(p.collision_h)
        self.COLLISION_R = float(p.collision_r)
        if initial_xyzs is None:
            initial_xyzs = core.default_init_xyzs(self.cfg, self.params)
        if initial_rpys is None:
            initial_rpys = np.zeros((num_drones, 3))
        self.INIT_XYZS = np.asarray(initial_xyzs, dtype=np.float64).reshape(
            num_drones, 3)
        self.INIT_RPYS = np.asarray(initial_rpys, dtype=np.float64).reshape(
            num_drones, 3)
        self.step_counter = 0
        self.RESET_TIME = time.time()
        self.first_render_call = True

    # -- subclass hooks (reference BaseAviary.py:1025-1108) ------------------
    def _actionSpace(self):
        raise NotImplementedError

    def _observationSpace(self):
        raise NotImplementedError

    def _stateVector(self) -> np.ndarray:
        raise NotImplementedError

    def _action(self, action, size):
        """A user action (N, size) as a (1, N, size) tensor on the env's
        device: the step's one upload."""
        a = np.asarray(action, dtype=np.float32).reshape(1, self.NUM_DRONES,
                                                         size)
        return torch.from_numpy(a).to(self.device, self.dtype)

    def render(self, mode: str = "human", close: bool = False):
        """Text render (reference BaseAviary.render:391-416)."""
        sv = self._stateVector()
        t_wall = time.time() - self.RESET_TIME
        sim = self.step_counter * self.PYB_TIMESTEP
        print(f"\n[INFO] render ——— it {self.step_counter:04d} ——— "
              f"wall-clock {t_wall:.1f}s, sim {sim:.1f}s@{self.PYB_FREQ}Hz "
              f"({sim / max(t_wall, 1e-9):.2f}x)")
        for i in range(self.NUM_DRONES):
            s = sv[i]
            print(f"[INFO] drone {i} ——— x {s[0]:+06.2f}, y {s[1]:+06.2f}, "
                  f"z {s[2]:+06.2f} ——— vel {s[10]:+06.2f}, {s[11]:+06.2f}, "
                  f"{s[12]:+06.2f} ——— rpy {np.degrees(s[7]):+06.2f}, "
                  f"{np.degrees(s[8]):+06.2f}, {np.degrees(s[9]):+06.2f} "
                  f"——— ang vel {s[13]:+06.4f}, {s[14]:+06.4f}, "
                  f"{s[15]:+06.4f}")

    def close(self):
        pass

    def _getDroneStateVector(self, nth_drone: int) -> np.ndarray:
        return self._stateVector()[nth_drone]

    def _phys(self):
        """The env's ``PhysState`` (leaves (1, N, ...) on the device)."""
        return self._state.phys

    # -- vision (reference BaseAviary._getDroneImages:569-621) ---------------
    IMG_RES = np.array([64, 48])

    def _scene(self):
        """The renderable scene: the ground, every drone's sphere and,
        with obstacles on, the landmark pillars (the reference's RGB-mode
        props, BaseRLAviary._addObstacles:106-126)."""
        pos = self._phys().pos[0]
        scene = render.drone_spheres(render.empty_scene(pos.dtype,
                                                        pos.device),
                                     pos, self.COLLISION_R)
        return render.add_landmarks(scene) if self.OBSTACLES else scene

    def _frames(self, drones):
        """(rgba (k, H, W, 4), depth, seg) of the drones ``drones``'
        cameras (one render, on the env's device)."""
        ph = self._phys()
        eye, target = render.drone_camera(ph.pos[0, drones],
                                          ph.quat[0, drones], self.L)
        return render.render(self._scene(), eye, target,
                             width=int(self.IMG_RES[0]),
                             height=int(self.IMG_RES[1]))

    def _getDroneImages(self, nth_drone: int, segmentation: bool = True):
        """(rgb (H, W, 4) uint8, depth (H, W), seg (H, W)) from the n-th
        drone's POV."""
        rgba, depth, seg = (x[0].cpu().numpy()
                            for x in self._frames([nth_drone]))
        return rgba.astype(np.uint8), depth, seg

    def _exportImage(self, img_type, img_input, path, frame_num: int = 0):
        from ..utils.rendering import export_image

        return export_image(img_type, img_input, path, frame_num)


def _state_space(num_drones, max_rpm):
    """(N, 20) state-vector box (reference CtrlAviary._observationSpace:
    90-102)."""
    lo = np.array([-np.inf, -np.inf, 0.0, -1, -1, -1, -1, -np.pi, -np.pi,
                   -np.pi] + [-np.inf] * 6 + [0.0] * 4, dtype=np.float32)
    hi = np.array([np.inf] * 3 + [1, 1, 1, 1, np.pi, np.pi, np.pi]
                  + [np.inf] * 6 + [max_rpm] * 4, dtype=np.float32)
    return box(np.tile(lo, (num_drones, 1)), np.tile(hi, (num_drones, 1)))


class CtrlAviary(AviaryBase):
    """Direct-RPM control playground (reference envs/CtrlAviary.py)."""

    def __init__(self, *, device="cuda", **kwargs):
        super().__init__(device=device, **kwargs)
        self._state = None

    def _actionSpace(self):
        # reference CtrlAviary._actionSpace:74-86
        n = self.NUM_DRONES
        return box(np.zeros((n, 4), dtype=np.float32),
                   np.full((n, 4), self.MAX_RPM, dtype=np.float32))

    def _observationSpace(self):
        return _state_space(self.NUM_DRONES, self.MAX_RPM)

    def reset(self, seed: Optional[int] = None,
              options: Optional[dict] = None):
        self._state = core.core_reset(self.cfg, self.INIT_XYZS,
                                      self.INIT_RPYS, 1, self.dtype,
                                      self.device)
        self.step_counter = 0
        self.RESET_TIME = time.time()
        return self._stateVector(), self._computeInfo()

    def step(self, action):
        rpm = torch.clamp(self._action(action, 4), 0.0, self.params.max_rpm)
        self._state = core.core_step(self.cfg, self.params, self._state, rpm)
        self.step_counter += self.PYB_STEPS_PER_CTRL
        return self._stateVector(), -1, False, False, self._computeInfo()

    def _stateVector(self):
        return core.state_vector(self._state)[0].cpu().numpy()

    def _computeInfo(self):
        return {"answer": 42}  # reference CtrlAviary._computeInfo


class VelocityAviary(AviaryBase):
    """Velocity commands through the DSL PID controller (reference
    envs/VelocityAviary.py)."""

    def __init__(self, *, device="cuda", **kwargs):
        super().__init__(device=device, **kwargs)
        self._state = self._ctl = None

    def _actionSpace(self):
        # reference VelocityAviary._actionSpace:82-94
        n = self.NUM_DRONES
        lo = np.tile(np.array([-1, -1, -1, 0], dtype=np.float32), (n, 1))
        return box(lo, np.ones((n, 4), dtype=np.float32))

    def _observationSpace(self):
        return _state_space(self.NUM_DRONES, self.MAX_RPM)

    def reset(self, seed: Optional[int] = None,
              options: Optional[dict] = None):
        self._state = core.core_reset(self.cfg, self.INIT_XYZS,
                                      self.INIT_RPYS, 1, self.dtype,
                                      self.device)
        self._ctl = dslpid.init_state((1, self.NUM_DRONES), self.dtype,
                                      self.device)
        self.step_counter = 0
        self.RESET_TIME = time.time()
        return self._stateVector(), {"answer": 42}

    def step(self, action):
        action = self._action(action, 4)
        params = self.params
        sv = core.state_vector(self._state)
        pos, q, vel, yaw = sv[..., 0:3], sv[..., 3:7], sv[..., 10:13], sv[..., 9]
        target, kw = rl.vel_targets(params, pos, yaw, action)
        rpm, self._ctl, _, _ = dslpid.compute_control(
            params, self._ctl, self.cfg.ctrl_timestep, pos, q, vel, target,
            **kw)
        self._state = core.core_step(self.cfg, params, self._state, rpm)
        self.step_counter += self.PYB_STEPS_PER_CTRL
        return self._stateVector(), -1, False, False, {"answer": 42}

    def _stateVector(self):
        return core.state_vector(self._state)[0].cpu().numpy()


class BaseRLAviary(AviaryBase):
    """Gymnasium shell over the RL env of envs/rl.py (reference
    envs/BaseRLAviary.py)."""

    TASK = None
    EPISODE_LEN_SEC = 8

    def __init__(self, drone_model: DroneModel = DroneModel.CF2X,
                 num_drones: int = 1, neighbourhood_radius: float = np.inf,
                 initial_xyzs=None, initial_rpys=None,
                 physics: Physics = Physics.PYB, pyb_freq: int = 240,
                 ctrl_freq: int = 30, gui: bool = False,
                 record: bool = False,
                 obs: ObservationType = ObservationType.KIN,
                 act: ActionType = ActionType.RPM, dtype=torch.float32,
                 device="cuda"):
        self.OBS_TYPE = obs
        self.ACT_TYPE = act
        self.rl_cfg = rl.RLConfig(
            aviary=AviaryConfig(drone_model=drone_model,
                                num_drones=num_drones, physics=physics,
                                pyb_freq=pyb_freq, ctrl_freq=ctrl_freq,
                                neighbourhood_radius=neighbourhood_radius),
            obs_type=obs, act_type=act,
            episode_len_sec=self.EPISODE_LEN_SEC, task=self.TASK)
        self.ACTION_BUFFER_SIZE = self.rl_cfg.action_buffer_size
        super().__init__(drone_model=drone_model, num_drones=num_drones,
                         neighbourhood_radius=neighbourhood_radius,
                         initial_xyzs=initial_xyzs,
                         initial_rpys=initial_rpys, physics=physics,
                         pyb_freq=pyb_freq, ctrl_freq=ctrl_freq, gui=gui,
                         record=record, obstacles=True,
                         user_debug_gui=False, dtype=dtype, device=device)
        self._state = None
        self._rgb_cache = None

    def _actionSpace(self):
        size = self.rl_cfg.act_size
        ones = np.ones((self.NUM_DRONES, size), dtype=np.float32)
        return box(-ones, ones)

    def _observationSpace(self):
        if self.OBS_TYPE == ObservationType.RGB:
            # reference BaseRLAviary._observationSpace:252-255
            return box(0, 255, np.uint8,
                       (self.NUM_DRONES, int(self.IMG_RES[1]),
                        int(self.IMG_RES[0]), 4))
        # reference BaseRLAviary._observationSpace:256-277
        buf = self.rl_cfg.action_buffer_size * self.rl_cfg.act_size
        lo = np.array([-np.inf, -np.inf, 0.0] + [-np.inf] * 9 + [-1.0] * buf,
                      dtype=np.float32)
        hi = np.array([np.inf] * 12 + [1.0] * buf, dtype=np.float32)
        return box(np.tile(lo, (self.NUM_DRONES, 1)),
                   np.tile(hi, (self.NUM_DRONES, 1)))

    def reset(self, seed: Optional[int] = None,
              options: Optional[dict] = None):
        self._state = rl.rl_reset(self.rl_cfg, self.INIT_XYZS,
                                  self.INIT_RPYS, 1, self.dtype, self.device)
        self.step_counter = 0
        self.RESET_TIME = time.time()
        self._rgb_cache = None
        if self.OBS_TYPE == ObservationType.RGB:
            return self._rgbObs(), self._computeInfo()
        obs = rl.compute_obs(self.rl_cfg, self._state)[0]
        return obs.cpu().numpy().astype(np.float32), self._computeInfo()

    def _phys(self):
        return self._state.core.phys

    def _rgbObs(self):
        """(N, H, W, 4) float32 drone-POV frames of uint8 values (reference
        _computeObs:293-306), captured at 24 frames a second (every
        control step whose counter is a multiple of the capture period)
        and cached between captures."""
        capture_freq = int(self.PYB_FREQ / 24)
        period = max(capture_freq - capture_freq % self.PYB_STEPS_PER_CTRL,
                     self.PYB_STEPS_PER_CTRL)
        if self._rgb_cache is None or self.step_counter % period == 0:
            rgba = self._frames(list(range(self.NUM_DRONES)))[0]
            self._rgb_cache = (rgba.cpu().numpy().astype(np.uint8)
                               .astype(np.float32))
        return self._rgb_cache

    def step(self, action):
        self._state, obs, reward, term, trunc = rl.rl_step(
            self.rl_cfg, self.params, self._state,
            self._action(action, self.rl_cfg.act_size))
        self.step_counter += self.PYB_STEPS_PER_CTRL
        # one download: obs, reward, terminated, truncated
        packed = torch.cat([obs[0].reshape(-1), reward.to(obs.dtype),
                            term.to(obs.dtype), trunc.to(obs.dtype)])
        packed = packed.cpu().numpy()
        n = obs[0].numel()
        obs_out = (self._rgbObs() if self.OBS_TYPE == ObservationType.RGB
                   else packed[:n].reshape(obs.shape[1:]).astype(np.float32))
        return (obs_out, float(packed[n]), bool(packed[n + 1] > 0.5),
                bool(packed[n + 2] > 0.5), self._computeInfo())

    def _stateVector(self):
        return core.state_vector(self._state.core)[0].cpu().numpy()

    def _computeInfo(self):
        return {"answer": 42}


class HoverAviary(BaseRLAviary):
    """Single-agent hover at [0, 0, 1] (reference envs/HoverAviary.py)."""

    TASK = "hover"
    EPISODE_LEN_SEC = 8

    def __init__(self, *, device="cuda", **kwargs):
        kwargs["num_drones"] = 1
        kwargs.setdefault("ctrl_freq", 30)
        super().__init__(device=device, **kwargs)
        self.TARGET_POS = np.array([0, 0, 1])


class MultiHoverAviary(BaseRLAviary):
    """Multi-agent hover (reference envs/MultiHoverAviary.py)."""

    TASK = "multihover"
    EPISODE_LEN_SEC = 8

    def __init__(self, num_drones: int = 2, *, device="cuda", **kwargs):
        kwargs["num_drones"] = num_drones
        kwargs.setdefault("ctrl_freq", 30)
        super().__init__(device=device, **kwargs)
        self.TARGET_POS = self.INIT_XYZS + np.array(
            [[0, 0, 1 / (i + 1)] for i in range(num_drones)])
