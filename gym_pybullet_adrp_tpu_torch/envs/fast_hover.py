"""The fast hover env: packed layout and the fused control-step kernel.

Counterpart of gym_pybullet_adrp_tpu/envs/fast_hover.py (``FastHoverState``
:28, ``reset_packed`` :33, ``make_step`` :44, ``ppo_adapter`` :109): the
throughput configuration of the RL hover env (one CF2X, Physics.PYB, RPM
actions, 240/30 Hz) with the state in the channel-major (13, B/128, 128)
layout for the whole rollout. Physics is one launch of K1
(``ops.hover_step.ctrl_step_packed``) per control step; the observation's
atan2/asin tail, the HoverAviary reward, done and the autoreset are plain
PyTorch, as the JAX package computes them in XLA. Unlike envs/rl.py the
observation has no action-history block.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..models.drone import DroneParams
from ..ops import hover_step

LANE = hover_step.LANE


class FastHoverState(NamedTuple):
    packed: torch.Tensor       # (13, B/128, 128)
    step_count: torch.Tensor   # (B/128, 128) int32, ctrl steps this episode


def reset_packed(init_xyz, B, dtype=torch.float32,
                 device="cuda") -> FastHoverState:
    """B envs at rest at ``init_xyz``, identity attitude."""
    T = B // LANE
    st = np.zeros((hover_step.N_CHANNELS, T, LANE), dtype=np.float32)
    st[0:3] = np.asarray(init_xyz, dtype=np.float32)[:, None, None]
    st[6] = 1.0  # quat w
    return FastHoverState(
        packed=torch.as_tensor(st, dtype=dtype, device=device),
        step_count=torch.zeros((T, LANE), dtype=torch.int32, device=device),
    )


def make_step(params: DroneParams, B: int, ctrl_freq: int = 30,
              pyb_freq: int = 240, episode_len_sec: float = 8.0,
              target=(0.0, 0.0, 1.0), device="cuda"):
    """Build ``step(state, action) -> (state, (obs12, reward, done))``.

    action: (4, B/128, 128) in [-1, 1], RPM type (rpm = HOVER_RPM (1 +
    0.05 a), reference BaseRLAviary:192); obs12 (12, B/128, 128): pos,
    roll/pitch/yaw, vel, body rates."""
    n_sub = pyb_freq // ctrl_freq
    dt = 1.0 / pyb_freq
    hover = float(params.hover_rpm)
    tx, ty, tz = target
    max_steps = int(episode_len_sec * ctrl_freq)
    reset_template = reset_packed(np.array([tx, ty, 0.1125]), B,
                                  device=device)
    consts = hover_step.hover_consts(params, n_sub, dt)

    def step(state: FastHoverState, action):
        hover_step.refuse_grad("fast_hover.step", hover_step.HOVER_EAGER,
                               state.packed, action)
        rpm = (hover * (1.0 + 0.05 * action)).contiguous()
        packed = hover_step.ctrl_step_packed(params, state.packed, rpm,
                                             n_sub, dt, consts=consts)
        px, py, pz = packed[0], packed[1], packed[2]
        qx, qy, qz, qw = packed[3], packed[4], packed[5], packed[6]

        # roll/pitch for the tilt truncation (reference HoverAviary:110-112)
        sinr = 2.0 * (qw * qx + qy * qz)
        cosr = 1.0 - 2.0 * (qx * qx + qy * qy)
        roll = torch.atan2(sinr, cosr)
        pitch = torch.asin(torch.clamp(2.0 * (qw * qy - qz * qx), -1.0, 1.0))

        err2 = (px - tx) ** 2 + (py - ty) ** 2 + (pz - tz) ** 2
        err = torch.sqrt(err2)
        reward = torch.clamp_min(2.0 - err2 * err2, 0.0)
        terminated = err < 1e-4
        step_count = state.step_count + 1
        truncated = ((torch.abs(px) > 1.5) | (torch.abs(py) > 1.5)
                     | (pz > 2.0) | (torch.abs(roll) > 0.4)
                     | (torch.abs(pitch) > 0.4) | (step_count > max_steps))
        done = terminated | truncated

        packed = torch.where(done[None], reset_template.packed, packed)
        step_count = torch.where(done, 0, step_count)

        # the post-reset attitude is identity: zero the angles of done envs
        yaw = torch.atan2(2.0 * (qw * qz + qx * qy),
                          1.0 - 2.0 * (qy * qy + qz * qz))
        zero = torch.zeros_like(roll)
        obs12 = torch.stack(
            [packed[0], packed[1], packed[2],
             torch.where(done, zero, roll),
             torch.where(done, zero, pitch),
             torch.where(done, zero, yaw),
             packed[7], packed[8], packed[9], packed[10], packed[11],
             packed[12]],
            dim=0,
        )
        return FastHoverState(packed=packed, step_count=step_count), (
            obs12, reward, done)

    return step


def ppo_adapter(params: DroneParams, n_envs: int, ctrl_freq: int = 30,
                pyb_freq: int = 240, device="cuda"):
    """EnvAdapter (rl/ppo.py) over the fused-kernel path: the 12-dim
    kinematic observation (no action history), 4-dim RPM actions."""
    from ..rl.ppo import EnvAdapter

    T = n_envs // LANE
    step_fn = make_step(params, n_envs, ctrl_freq=ctrl_freq,
                        pyb_freq=pyb_freq, device=device)

    def _obs_to_batch(obs12):
        # (12, T, 128) -> (n_envs, 12)
        return obs12.reshape(12, n_envs).T

    def batched_reset():
        state = reset_packed(np.array([0.0, 0.0, 0.1125]), n_envs,
                             device=device)
        obs0 = torch.zeros((12, T, LANE), dtype=state.packed.dtype,
                           device=device)
        obs0[2] = 0.1125
        return state, _obs_to_batch(obs0)

    def step(state, action):
        act_packed = action.T.reshape(4, T, LANE)
        state, (obs12, reward, done) = step_fn(state, act_packed)
        return (state, _obs_to_batch(obs12), reward.reshape(n_envs),
                done.reshape(n_envs))

    return EnvAdapter(batched_reset=batched_reset, step=step, obs_dim=12,
                      act_dim=4)
