"""RL envs: BaseRLAviary mechanics with the Hover and MultiHover tasks.

Counterpart of gym_pybullet_adrp_tpu/envs/rl.py (``RLConfig`` :42,
``RLState`` :68, ``hover_target`` :77, ``rl_reset`` :92,
``preprocess_action`` :105, ``compute_obs`` :159, ``compute_rgb_obs``
:168, ``compute_reward``
:208, ``compute_terminated`` :216, ``compute_truncated`` :224,
``rl_step`` :243, ``autoreset_step_with_final`` :266, ``autoreset_step``
:289), batched: every function takes and returns a leading env axis B.
The half-second action history of the reference (a deque) is a rolled
tensor in the state.

Every action type of the JAX package: RPM and ONE_D_RPM scale the hover
RPM; PID, VEL and ONE_D_PID run the DSL PID controller
(``control/dslpid.py``), whose state ``RLState.ctrl`` carries per drone.
``compute_rgb_obs`` renders drone 0's POV frame of every env at once
(ops/render.py).
"""

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import core
from .core import AviaryConfig, CoreState
from ..control import dslpid
from ..models.drone import DroneParams
from ..ops import render
from ..utils.enums import ActionType, DroneModel, ObservationType


def action_size(act: ActionType) -> int:
    """Reference BaseRLAviary._actionSpace:141-149."""
    if act in (ActionType.RPM, ActionType.VEL):
        return 4
    if act == ActionType.PID:
        return 3
    if act in (ActionType.ONE_D_RPM, ActionType.ONE_D_PID):
        return 1
    raise ValueError(f"unsupported ActionType {act}")


@dataclass(frozen=True)
class RLConfig:
    """Static RL env configuration."""

    aviary: AviaryConfig = field(
        default_factory=lambda: AviaryConfig(ctrl_freq=30))
    obs_type: ObservationType = ObservationType.KIN
    act_type: ActionType = ActionType.RPM
    episode_len_sec: float = 8.0
    # reward/termination: "hover" | "multihover" | None
    task: Optional[str] = "hover"

    @property
    def action_buffer_size(self) -> int:
        return int(self.aviary.ctrl_freq // 2)

    @property
    def act_size(self) -> int:
        return action_size(self.act_type)

    @property
    def obs_size(self) -> int:
        return 12 + self.action_buffer_size * self.act_size


class RLState(NamedTuple):
    """Dynamic state of B RL envs."""

    core: CoreState
    ctrl: dslpid.PIDState            # (B, N, 3) leaves
    action_buffer: torch.Tensor      # (B, BUF, N, A), index 0 = oldest
    target_pos: torch.Tensor         # (B, N, 3)


def hover_target(cfg: RLConfig, init_xyzs) -> torch.Tensor:
    """HoverAviary: [0, 0, 1]; MultiHover: INIT_XYZ + [0, 0, 1/(i+1)]
    (init_xyzs (..., N, 3) -> the same shape)."""
    n = cfg.aviary.num_drones
    init = torch.as_tensor(init_xyzs)
    if cfg.task == "multihover":
        off = np.stack([np.zeros(n), np.zeros(n), 1.0 / (np.arange(n) + 1)],
                       axis=-1)
        return init + torch.as_tensor(off, dtype=init.dtype,
                                      device=init.device)
    return torch.tensor([0.0, 0.0, 1.0], dtype=init.dtype,
                        device=init.device).expand(init.shape).clone()


def rl_reset(cfg: RLConfig, init_xyzs, init_rpys, batch: int = 1,
             dtype=torch.float32, device="cuda") -> RLState:
    """``batch`` fresh envs at the initial poses (N, 3), or (B, N, 3)
    per env."""
    cstate = core.core_reset(cfg.aviary, init_xyzs, init_rpys, batch, dtype,
                             device)
    n = cfg.aviary.num_drones
    return RLState(
        core=cstate,
        ctrl=dslpid.init_state((batch, n), dtype, device),
        action_buffer=torch.zeros(
            (batch, cfg.action_buffer_size, n, cfg.act_size), dtype=dtype,
            device=device),
        target_pos=hover_target(cfg, cstate.phys.pos),
    )


def preprocess_action(cfg: RLConfig, params: DroneParams, state: RLState,
                      action):
    """Action (B, N, A) in [-1, 1] -> (motor rpm (B, N, 4), ctrl state)
    (reference BaseRLAviary._preprocessAction:160-239)."""
    act = cfg.act_type
    ctl = state.ctrl
    if act in (ActionType.RPM, ActionType.ONE_D_RPM):
        rpm = params.hover_rpm * (1.0 + 0.05 * action)
        if act == ActionType.ONE_D_RPM:
            rpm = torch.repeat_interleave(rpm, 4, dim=-1)
        return rpm, ctl
    sv = core.state_vector(state.core)
    pos, q, vel, yaw = sv[..., 0:3], sv[..., 3:7], sv[..., 10:13], sv[..., 9]
    dt = cfg.aviary.ctrl_timestep
    if act == ActionType.PID:
        target, kw = core.calculate_next_step(pos, action, 1.0), {}
    elif act == ActionType.VEL:
        target, kw = vel_targets(params, pos, yaw, action)
    elif act == ActionType.ONE_D_PID:
        z = torch.zeros_like(action)
        target, kw = pos + 0.1 * torch.cat([z, z, action], dim=-1), {}
    else:
        raise ValueError(f"unsupported ActionType {act}")
    rpm, ctl, _, _ = dslpid.compute_control(params, ctl, dt, pos, q, vel,
                                            target, model=DroneModel.CF2X,
                                            **kw)
    return rpm, ctl


def vel_targets(params: DroneParams, pos, yaw, action):
    """The VEL action's controller target: hold ``pos`` and ``yaw`` and
    fly at speed_limit * |a[3]| along a[:3] (reference
    BaseRLAviary._preprocessAction's VEL branch and
    VelocityAviary._preprocessAction). Returns (target_pos, keyword args of
    ``dslpid.compute_control``)."""
    norm = torch.linalg.norm(action[..., 0:3], dim=-1, keepdim=True)
    v_unit = torch.where(
        norm > 0, action[..., 0:3] / torch.clamp_min(norm, 1e-12), 0.0)
    z = torch.zeros_like(yaw)
    return pos, dict(target_rpy=torch.stack([z, z, yaw], dim=-1),
                     target_vel=(params.speed_limit
                                 * torch.abs(action[..., 3:4]) * v_unit))


def compute_obs(cfg: RLConfig, state: RLState) -> torch.Tensor:
    """(B, N, 12 + BUF*A) KIN obs + action history
    (reference BaseRLAviary._computeObs:307-319)."""
    obs12 = core.kin_obs_12(state.core)
    buf = state.action_buffer
    B, _, n, _ = buf.shape
    buf = buf.permute(0, 2, 1, 3).reshape(B, n, -1)
    return torch.cat([obs12, buf], dim=-1)


def compute_rgb_obs(cfg: RLConfig, params: DroneParams, state: RLState,
                    width: int = 32, height: int = 24) -> torch.Tensor:
    """Drone 0's POV frame of each env, flat (B, H*W*3) in [0, 1], on the
    state's device: the checkerboard ground, the 4 landmark pillars (the
    reference's RGB-mode props, BaseRLAviary._addObstacles:106-126) and,
    with N > 1, the other drones (the camera drone's own sphere masked
    out: the eye sits inside it). The reference's RGB observation mode
    (BaseRLAviary._computeObs:284-305) copied host camera frames."""
    pos, quat = state.core.phys.pos, state.core.phys.quat
    B, n = pos.shape[:2]
    scene = render.add_landmarks(render.empty_scene(pos.dtype, pos.device))
    if n > 1:
        scene = render.drone_spheres(
            scene, pos, valid=torch.arange(n, device=pos.device) != 0)
    eye, target = render.drone_camera(pos[:, 0], quat[:, 0], params.arm)
    rgba, _, _ = render.render(scene, eye, target, width=width,
                               height=height)
    return (rgba[..., :3] / 255.0).reshape(B, -1)


def _target_err(state: RLState):
    return torch.linalg.norm(state.target_pos - state.core.phys.pos, dim=-1)


def compute_reward(cfg: RLConfig, state: RLState) -> torch.Tensor:
    """(B,) reward (reference HoverAviary.py:68-79,
    MultiHoverAviary.py:75-88)."""
    err = _target_err(state)
    return torch.sum(torch.clamp_min(2.0 - err ** 4, 0.0), dim=-1)


def compute_terminated(cfg: RLConfig, state: RLState) -> torch.Tensor:
    """(B,) bool (reference HoverAviary.py:83-96,
    MultiHoverAviary.py:92-108)."""
    err = _target_err(state)
    if cfg.task == "multihover":
        return torch.sum(err, dim=-1) < 1e-4
    return err[:, 0] < 1e-4


def compute_truncated(cfg: RLConfig, state: RLState) -> torch.Tensor:
    """(B,) bool (reference HoverAviary.py:100-117,
    MultiHoverAviary.py:112-130)."""
    pos = state.core.phys.pos
    rpy = state.core.phys.rpy
    xy_bound = 2.0 if cfg.task == "multihover" else 1.5
    out = ((torch.abs(pos[..., 0]) > xy_bound)
           | (torch.abs(pos[..., 1]) > xy_bound)
           | (pos[..., 2] > 2.0)
           | (torch.abs(rpy[..., 0]) > 0.4)
           | (torch.abs(rpy[..., 1]) > 0.4))
    timeout = (state.core.step_counter.to(torch.float32)
               / cfg.aviary.pyb_freq > cfg.episode_len_sec)
    return torch.any(out, dim=-1) | timeout


def rl_step(cfg: RLConfig, params: DroneParams, state: RLState, action):
    """One step of B envs. Returns (state, obs, reward, terminated,
    truncated) (reference BaseAviary.step for the RL envs)."""
    B = state.action_buffer.shape[0]
    action = torch.as_tensor(
        action, dtype=state.core.phys.pos.dtype,
        device=state.core.phys.pos.device,
    ).reshape(B, cfg.aviary.num_drones, cfg.act_size)
    buf = torch.cat([state.action_buffer[:, 1:], action[:, None]], dim=1)
    rpm, ctl = preprocess_action(cfg, params, state, action)
    cstate = core.core_step(cfg.aviary, params, state.core, rpm)
    new_state = RLState(core=cstate, ctrl=ctl, action_buffer=buf,
                        target_pos=state.target_pos)
    obs = compute_obs(cfg, new_state)
    reward = compute_reward(cfg, new_state)
    terminated = compute_terminated(cfg, new_state)
    truncated = compute_truncated(cfg, new_state)
    return new_state, obs, reward, terminated, truncated


def _select(done, reset, new):
    """Per leaf: the reset template's value (batch 1 or B) where done."""
    if new is None:
        return None
    if isinstance(new, tuple):
        return type(new)(*(_select(done, r, n) for r, n in zip(reset, new)))
    return torch.where(done.reshape((-1,) + (1,) * (new.dim() - 1)),
                       reset, new)


def autoreset_step_with_final(cfg: RLConfig, params: DroneParams,
                              reset_state: RLState, state: RLState, action):
    """``rl_step`` with auto-reset on done; also returns the ended
    episode's last observation. ``reset_state`` has batch 1 or B."""
    new_state, obs, reward, terminated, truncated = rl_step(
        cfg, params, state, action)
    done = terminated | truncated
    final_obs = obs
    new_state = _select(done, reset_state, new_state)
    # on episode end the returned obs is the fresh episode's first obs
    obs = torch.where(done[:, None, None], compute_obs(cfg, new_state), obs)
    return new_state, obs, final_obs, reward, terminated, truncated


def autoreset_step(cfg: RLConfig, params: DroneParams, reset_state: RLState,
                   state: RLState, action):
    """Step + auto-reset on done (the VecEnv episode-boundary pattern)."""
    new_state, obs, _, reward, terminated, truncated = (
        autoreset_step_with_final(cfg, params, reset_state, state, action))
    return new_state, obs, reward, terminated, truncated
