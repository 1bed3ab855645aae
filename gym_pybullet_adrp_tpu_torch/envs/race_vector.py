"""Batched race envs behind the gymnasium ``VectorEnv`` API.

Counterpart of gym_pybullet_adrp_tpu/envs/race_vector.py
(``JaxRaceVectorEnv`` :52 as ``TorchRaceVectorEnv``): the public batched
race surface. With ``backend="auto"`` (or ``"fused"``) it runs on the row
env's fused step, one launch of the race_step kernel a step
(``race_rl_rowfast.make_row_env(..., telemetry=True)``) whenever the
spec qualifies (PYB physics, CF2X drones, ``num_envs`` a multiple of
128), and otherwise on the general race env
(``race_rl.batched_rl_race_step(..., telemetry=True)``), which
``backend="general"`` forces.

Semantics as the JAX class: the reference's MultiRaceAviary step with
the RewardWrapper shaping (drone 0's, or each drone's own with
``per_drone_reward``, the default for N > 1 on the fused backend) and
SAME-STEP autoreset. ``infos`` hold the ended episode's pre-autoreset
race telemetry straight from the kernel's telemetry rows
(``current_gate``, ``eliminated``, ``finished``, ``ep_steps``,
``task_completed``); no terminal observation is emitted, since the
kernel overwrites done rows in the launch. Each step uploads the actions
once and downloads one packed tensor.

``reset(seed=...)`` seeds the env's ``torch.Generator``, which draws the
resets, autoresets and disturbances: equal seeds give equal
trajectories (the JAX package keys ``jax.random``, so the draws differ
between the packages).
"""

from typing import Optional

import numpy as np
import torch

from . import race as race_mod
from . import race_rl, race_rl_rowfast
from .vector import UNSEEDED_BASE, VectorSpaces
from ..utils.config import load_config
from ..utils.enums import Physics, RaceMode


class TorchRaceVectorEnv(VectorSpaces):
    """N-drone race scenarios, a batch of ``num_envs`` on ``device`` (the
    card unless the caller asks for the CPU). Actions (num_envs, 4) for
    one drone or (num_envs, N, 4), in [-1, 1]: the reference
    RLController's pose-relative FULLSTATE offsets, yaw held."""

    def __init__(self, num_envs: int, config="getting_started",
                 num_drones: int = 1, racemode: Optional[RaceMode] = None,
                 physics: Physics = Physics.PYB,
                 per_drone_reward: Optional[bool] = None,
                 end_after_gate: int = 0, backend: str = "auto",
                 device="cuda"):
        """``backend``: "auto" takes the fused row kernel whenever the
        spec qualifies, "fused" requires it, "general" forces the general
        env."""
        cfg = load_config(config) if isinstance(config, str) else config
        if racemode is None:
            racemode = RaceMode.COMPETE if num_drones > 1 else RaceMode.COMPARE
        spec = race_mod.RaceSpec.from_config(cfg, num_drones, racemode,
                                             physics)
        fused_ok = backend != "general" and (
            race_rl_rowfast.supports(spec) and num_envs % 128 == 0)
        if per_drone_reward is None:
            per_drone_reward = num_drones > 1 and fused_ok
        self.fused_backend = fused_ok
        if backend == "fused" and not fused_ok:
            raise ValueError("backend='fused' needs PYB physics, CF2X drones "
                             "and num_envs a multiple of 128")
        if per_drone_reward and not fused_ok:
            raise ValueError("per_drone_reward requires the fused row "
                             "backend (PYB physics, CF2X drones, num_envs a "
                             "multiple of 128); the general env shapes drone "
                             "0's reward only")
        self.device = torch.device(device)
        self.spec_ = spec
        self.track = race_mod.track_from_config(cfg, num_drones)
        self.num_envs = num_envs
        self._n = num_drones
        self._per_drone_reward = per_drone_reward
        self._end_after_gate = end_after_gate
        self._gen = torch.Generator(device=self.device)
        self._obs_shape = ((spec.obs_size,) if num_drones == 1
                           else (num_drones, spec.obs_size))
        if fused_ok:
            self.env = race_rl_rowfast.make_row_env(
                spec, self.track, num_envs, device=self.device,
                generator=self._gen, telemetry=True,
                per_drone_reward=per_drone_reward,
                end_after_gate=end_after_gate)
        else:
            self.env = None
            self._track_t = race_mod.track_tensors(self.track, self.device)
        self._state = None
        self._unseeded_count = UNSEEDED_BASE

    def _single_spaces(self):
        from gymnasium import spaces

        act = (4,) if self._n == 1 else (self._n, 4)
        return (spaces.Box(low=-np.inf, high=np.inf, shape=self._obs_shape,
                           dtype=np.float32),
                spaces.Box(low=-1.0, high=1.0, shape=act, dtype=np.float32))

    def reset(self, seed: Optional[int] = None,
              options: Optional[dict] = None):
        if seed is None:
            seed = self._unseeded_count
            self._unseeded_count += 1
        self._gen.manual_seed(int(seed))
        B = self.num_envs
        if self.env is not None:
            self._state = self.env.reset()
            obs = self.env.initial_obs(self._state)
        else:
            self._state = race_rl.rl_race_reset(
                self.spec_, self._track_t, B, generator=self._gen,
                device=self.device)
            obs = race_mod.compute_obs(self.spec_, self._track_t,
                                       self._state.race)
        obs = obs.reshape((B,) + self._obs_shape)
        return obs.cpu().numpy().astype(np.float32), {}

    def _step_device(self, act):
        """One step on the device: (packed rows (B, ...), the reward's
        column count)."""
        B, N, f = self.num_envs, self._n, torch.float32
        if self.env is not None:
            self._state, obs, reward, done, info = self.env.step(
                self._state, act)
            term = info["terminated"]
        else:
            self._state, obs, reward, term, trunc, info = (
                race_rl.batched_rl_race_step(
                    self.spec_, self._track_t, self._state,
                    act.reshape(B, N, 4), generator=self._gen,
                    end_after_gate=self._end_after_gate, telemetry=True))
            done = term | trunc
        rc = N if self._per_drone_reward else 1
        cols = [obs.reshape(B, -1), reward.reshape(B, rc), done[:, None],
                term[:, None]]
        cols += [info[k].reshape(B, N)
                 for k in ("current_gate", "eliminated", "finished")]
        cols.append(info["ep_steps"].reshape(B, 1))
        return torch.cat([c.to(f) for c in cols], dim=1), rc

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("TorchRaceVectorEnv.step() called before "
                               "reset(); call reset() first")
        B, N = self.num_envs, self._n
        shape = (B, 4) if N == 1 else (B, N, 4)
        act = torch.from_numpy(np.asarray(actions, dtype=np.float32)
                               .reshape(shape)).to(self.device)
        packed, rc = self._step_device(act)
        packed = packed.cpu().numpy()          # the step's one download
        i = int(np.prod(self._obs_shape))
        obs = packed[:, :i].reshape((B,) + self._obs_shape)
        reward = packed[:, i:i + rc]
        reward = reward[:, 0] if rc == 1 else reward
        i += rc
        done = packed[:, i] > 0.5
        term = packed[:, i + 1] > 0.5
        i += 2
        cg = packed[:, i:i + N]
        elim = packed[:, i + N:i + 2 * N] > 0.5
        fin = packed[:, i + 2 * N:i + 3 * N] > 0.5
        infos = {
            # pre-autoreset race telemetry
            "current_gate": cg if N > 1 else cg[:, 0],
            "eliminated": elim if N > 1 else elim[:, 0],
            "finished": fin if N > 1 else fin[:, 0],
            "ep_steps": packed[:, i + 3 * N],
            # the reference's task_completed: every drone finished
            "task_completed": fin.all(axis=1),
        }
        return obs, reward, term, done & ~term, infos
