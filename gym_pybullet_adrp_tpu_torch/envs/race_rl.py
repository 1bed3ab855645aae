"""The general race env as an RL env: shaped reward, autoreset, batch step.

Counterpart of gym_pybullet_adrp_tpu/envs/race_rl.py (``ACTION_SCALE``,
``RaceRLState``, ``rl_race_reset`` :38, ``quat_rotate_x`` :108,
``shaped_reward`` :115, ``rl_race_step`` :149, ``autoreset_race_step``
:191, ``batched_rl_race_step`` :210) without the RGB observation. The
policy's action in [-1, 1]^4 is scaled by [1, 1, 1, pi], its yaw zeroed,
and added to the drone's pose as a FULLSTATE target (the reference's
RLController); the reward is the reference RewardWrapper's drone-0
shaping.

Batched, like envs/race.py: every function takes B envs at once. The
JAX package's per-env ``autoreset_race_step`` and its vmapped
``batched_rl_race_step`` are one function here; the autoreset computes
the reset of every env and selects it where an episode ended, as the
JAX package does, from the caller's ``reset_draws`` or its generator.
"""

import math
from typing import NamedTuple

import torch

from ..ops import quat as quat_ops
from ..utils.device_consts import const
from . import race as race_mod
from . import race_fast
from .race import RaceSpec, RaceState, RaceTrack

ACTION_SCALE = (1.0, 1.0, 1.0, math.pi)


class RaceRLState(NamedTuple):
    """Race state + the reward shaping's memory (reference RewardWrapper,
    wrapper.py:80-99), per env."""

    race: RaceState
    current_gate_id: torch.Tensor   # (B,) int32 (drone 0)
    current_target: torch.Tensor    # (B, 4) [x, y, z, yaw] of that gate
    previous_pos: torch.Tensor      # (B, 3)


def rl_race_reset(spec: RaceSpec, track: RaceTrack, B: int, draws=None,
                  generator=None, device="cuda",
                  dtype=torch.float32) -> RaceRLState:
    """B fresh episodes and their shaping memory (from the first obs)."""
    rs = race_mod.race_reset(spec, track, B, draws, generator, device, dtype)
    obs = race_mod.compute_obs(spec, track, rs)
    return RaceRLState(race=rs,
                       current_gate_id=obs[:, 0, -1].to(torch.int32),
                       current_target=obs[:, 0, 12:16],
                       previous_pos=obs[:, 0, 0:3])


def quat_rotate_x(q):
    """Unit body +x axis in the world frame (the body camera's forward)."""
    x = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    x[..., 0] = 1.0
    return quat_ops.rotate(q, x)


def shaped_reward(spec: RaceSpec, state: RaceRLState, obs, terminated,
                  task_completed):
    """Dense progress + sparse pass / collision / lap reward of drone 0
    (reference RewardWrapper._compute_reward:121-186) from the post-step
    ``obs`` (B, N, C) and the pre-step shaping memory. Returns (reward
    (B,), gate id, target, pos)."""
    G = spec.num_gates
    B = obs.shape[0]
    gate_id = obs[:, 0, -1].to(torch.int32)
    gate_positions = obs[:, 0, 12:12 + 4 * G].reshape(B, G, 4)
    passed = gate_id > (state.current_gate_id % G)
    new_gate_id = torch.where(passed, gate_id, state.current_gate_id)
    idx = torch.clamp(gate_id, 0, G - 1).long()
    target = torch.gather(gate_positions, 1,
                          idx[:, None, None].expand(B, 1, 4))[:, 0]
    new_target = torch.where(passed[:, None], target, state.current_target)
    r_passed = torch.where(passed, 5.0, 0.0)
    r_collision = torch.where(terminated & ~task_completed, -1.0, 0.0)
    r_lap = torch.where(terminated & task_completed, 10.0, 0.0)

    pos = obs[:, 0, 0:3]
    prev = state.previous_pos

    def norm2(v):
        return torch.sqrt(torch.sum(v * v, dim=-1))

    d_prev_xy = norm2(new_target[:, 0:2] - prev[:, 0:2])
    d_cur_xy = norm2(new_target[:, 0:2] - pos[:, 0:2])
    d_prev_z = torch.abs(new_target[:, 2] - prev[:, 2])
    d_cur_z = torch.abs(new_target[:, 2] - pos[:, 2])
    reward = ((d_prev_xy - d_cur_xy) + (d_prev_z - d_cur_z) + r_passed
              + r_collision + r_lap)
    return reward, new_gate_id, new_target, pos


def rl_race_step(spec: RaceSpec, track: RaceTrack, state: RaceRLState,
                 action, end_after_gate: int = 0, fast: bool = False,
                 noise=None, generator=None, consts=None):
    """One shaped step of B envs without the autoreset. ``action`` (B, N,
    4) in [-1, 1]. ``end_after_gate`` > 0 ends an episode once drone 0 has
    passed that many gates (reference wrapper.py:61-63). ``fast`` runs
    the window in the K3 kernel (envs/race_fast.py, with ``consts``);
    otherwise ``race.race_step`` with ``noise`` or ``generator``'s draws.
    Returns (state, obs, reward, terminated, truncated, info)."""
    rs = state.race
    dtype = rs.phys.pos.dtype
    scale = const(ACTION_SCALE, dtype, action.device)
    act = action.to(dtype) * scale
    act = torch.cat([act[..., :3], torch.zeros_like(act[..., 3:])], dim=-1)
    pose = torch.cat([rs.phys.pos, rs.phys.rpy[..., 2:3]], dim=-1)
    cmd_ids, args = race_mod.actions_to_commands(
        spec, pose + act, rs.step_counter.to(dtype))
    if fast:
        rs, obs, _, terminated, truncated, info = (
            race_fast.batched_race_step_fast(spec, track, rs, cmd_ids, args,
                                             consts))
    else:
        rs, obs, _, terminated, truncated, info = race_mod.race_step(
            spec, track, rs, cmd_ids, args, noise, generator)
    if end_after_gate:
        terminated = terminated | (rs.current_gate[:, 0] >= end_after_gate)
    reward, gid, tgt, pos = shaped_reward(spec, state, obs, terminated,
                                          info["task_completed"])
    new_state = RaceRLState(race=rs, current_gate_id=gid,
                            current_target=tgt, previous_pos=pos)
    return new_state, obs, reward, terminated, truncated, info


def batched_rl_race_step(spec: RaceSpec, track: RaceTrack,
                         state: RaceRLState, action, reset_draws=None,
                         generator=None, end_after_gate: int = 0,
                         fast: bool = False, telemetry: bool = False,
                         noise=None, consts=None):
    """``rl_race_step`` + the autoreset: envs whose episode ended
    (terminated or truncated) restart from a reset drawn from
    ``reset_draws`` (``race.ResetDraws`` of B resets) or ``generator``,
    and their obs is the reset's. With ``telemetry`` a sixth value holds
    the pre-reset rows {current_gate, eliminated, finished, ep_steps}.
    Returns (state, obs (B, N, C), reward (B,), terminated, truncated[,
    telemetry])."""
    new_state, obs, reward, terminated, truncated, _ = rl_race_step(
        spec, track, state, action, end_after_gate, fast, noise, generator,
        consts)
    rs = new_state.race
    B = terminated.shape[0]
    done = terminated | truncated
    telem = None
    if telemetry:
        telem = {"current_gate": rs.current_gate,
                 "eliminated": rs.eliminated, "finished": rs.finished,
                 "ep_steps": rs.step_counter.to(obs.dtype)
                 / spec.steps_per_ctrl}
    reset = rl_race_reset(spec, track, B, reset_draws, generator,
                          obs.device, obs.dtype)
    new_state = race_mod.tree_where(done, reset, new_state)
    obs = torch.where(done[:, None, None],
                      race_mod.compute_obs(spec, track, new_state.race), obs)
    if telemetry:
        return new_state, obs, reward, terminated, truncated, telem
    return new_state, obs, reward, terminated, truncated
