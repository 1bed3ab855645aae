"""Batched hover envs behind the gymnasium ``VectorEnv`` API.

Counterpart of gym_pybullet_adrp_tpu/envs/vector.py (``JaxVectorEnv`` :50
as ``TorchVectorEnv``): ``num_envs`` HoverAviary or MultiHoverAviary
instances stepped as one batch of envs/rl.py on ``device``, with one
upload (the actions) and one download (obs, terminal obs, reward and
flags packed in one tensor) a step.

Autoreset is SAME-STEP: when an episode ends, the returned observation is
already the next episode's first, and the ended episode's terminal
observation is in ``infos`` under both spellings, ``final_obs`` /
``_final_obs`` (gymnasium >= 1.0) and ``final_observation`` /
``_final_observation`` (0.29 and SB3's VecEnv).

``reset(seed=...)`` seeds the env's ``torch.Generator``, which draws the
initial batch's and every autoreset's start-pose jitter
(``init_pos_jitter``/``init_rpy_jitter``): equal seeds give equal
batches. ``seed=None`` counts up from 2**31, so it never repeats a small
explicit seed. The JAX package keys ``jax.random`` instead, so the two
draw different jitters from one seed.

Like the aviaries (envs/aviary.py), the class imports gymnasium only when
its spaces are read.
"""

from typing import Optional

import numpy as np
import torch

from . import rl
from .aviary import HoverAviary, LazySpaces, MultiHoverAviary
from ..utils.enums import ActionType, DroneModel

# first seed of reset(seed=None): disjoint from the small explicit seeds
UNSEEDED_BASE = 1 << 31


def vector_metadata():
    """``{"render_modes": [], "autoreset_mode": SAME_STEP}``, the mode as
    gymnasium's enum where gymnasium is installed."""
    try:
        from gymnasium.vector import AutoresetMode
        mode = AutoresetMode.SAME_STEP
    except ImportError:
        mode = "SameStep"
    return {"render_modes": [], "autoreset_mode": mode}


def _batch(space, n):
    from gymnasium.vector.utils import batch_space

    return batch_space(space, n)


class VectorSpaces(LazySpaces):
    """``LazySpaces`` over ``num_envs`` copies of ``single_*_space``
    (``_single_spaces()`` -> (observation, action))."""

    @property
    def single_observation_space(self):
        return self._lazy("single", self._single_spaces)[0]

    @property
    def single_action_space(self):
        return self._lazy("single", self._single_spaces)[1]

    def _observationSpace(self):
        return _batch(self.single_observation_space, self.num_envs)

    def _actionSpace(self):
        return _batch(self.single_action_space, self.num_envs)

    @property
    def metadata(self):
        return vector_metadata()

    def render(self):
        return None

    def close(self, **kwargs):
        pass


class TorchVectorEnv(VectorSpaces):
    """Batched HoverAviary / MultiHoverAviary (task 'hover' or
    'multihover') on ``device``, the card unless the caller asks for the
    CPU."""

    def __init__(self, num_envs: int, task: str = "hover",
                 num_drones: int = 1,
                 drone_model: DroneModel = DroneModel.CF2X,
                 act: ActionType = ActionType.RPM, ctrl_freq: int = 30,
                 dtype=torch.float32, init_pos_jitter: float = 0.0,
                 init_rpy_jitter: float = 0.0, device="cuda"):
        """``init_pos_jitter``/``init_rpy_jitter``: every reset and
        autoreset draws uniform offsets in [-jitter, +jitter] (metres,
        radians) around the nominal start pose from the generator that
        ``reset(seed)`` seeds; 0 keeps the reference's fixed starts."""
        self.device = torch.device(device)
        if task == "multihover":
            proto = MultiHoverAviary(drone_model=drone_model,
                                     num_drones=max(num_drones, 2), act=act,
                                     ctrl_freq=ctrl_freq, dtype=dtype,
                                     device=self.device)
        else:
            proto = HoverAviary(drone_model=drone_model, act=act,
                                ctrl_freq=ctrl_freq, dtype=dtype,
                                device=self.device)
        self._proto = proto
        self.num_envs = num_envs
        self._cfg, self._params = proto.rl_cfg, proto.params
        self._n = proto.NUM_DRONES
        self._act_size = self._cfg.act_size
        self._dtype = dtype
        self._jitter = (float(init_pos_jitter), float(init_rpy_jitter))
        self._template = rl.rl_reset(self._cfg, proto.INIT_XYZS,
                                     proto.INIT_RPYS, 1, dtype, self.device)
        self._base = [torch.as_tensor(x, dtype=dtype, device=self.device)
                      for x in (proto.INIT_XYZS, proto.INIT_RPYS)]
        self._obs_shape = (self._n, self._cfg.obs_size)
        self._gen = torch.Generator(device=self.device)
        self._state = None
        self._unseeded_count = UNSEEDED_BASE

    def _single_spaces(self):
        return self._proto.observation_space, self._proto.action_space

    def _reset_states(self, full=False):
        """Per-env reset states with the seeded start-pose jitter; without
        jitter the batch-1 template, or with ``full`` a whole batch."""
        pj, rj = self._jitter
        xyz, rpy = self._base
        if pj or rj:
            shape = (self.num_envs, self._n, 3)
            u = [torch.rand(shape, generator=self._gen, device=self.device,
                            dtype=self._dtype) * 2.0 - 1.0 for _ in range(2)]
            xyz, rpy = xyz + pj * u[0], rpy + rj * u[1]
        elif not full:
            return self._template
        return rl.rl_reset(self._cfg, xyz, rpy, self.num_envs, self._dtype,
                           self.device)

    def reset(self, seed: Optional[int] = None,
              options: Optional[dict] = None):
        if seed is None:
            seed = self._unseeded_count
            self._unseeded_count += 1
        self._gen.manual_seed(int(seed))
        self._state = self._reset_states(full=True)
        obs = rl.compute_obs(self._cfg, self._state)
        return obs.cpu().numpy().astype(np.float32), {}

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("TorchVectorEnv.step() called before "
                               "reset(); call reset() first")
        B = self.num_envs
        act = torch.from_numpy(np.asarray(actions, dtype=np.float32).reshape(
            B, self._n, self._act_size)).to(self.device, self._dtype)
        self._state, obs, final_obs, reward, term, trunc = (
            rl.autoreset_step_with_final(self._cfg, self._params,
                                         self._reset_states(), self._state,
                                         act))
        # one download a step
        f = torch.float32
        packed = torch.cat([obs.reshape(B, -1).to(f),
                            final_obs.reshape(B, -1).to(f),
                            reward[:, None].to(f), term[:, None].to(f),
                            trunc[:, None].to(f)], dim=1).cpu().numpy()
        d = obs[0].numel()
        obs_out = packed[:, :d].reshape((B,) + self._obs_shape)
        reward = packed[:, 2 * d]
        term = packed[:, 2 * d + 1] > 0.5
        trunc = packed[:, 2 * d + 2] > 0.5
        done = term | trunc
        infos = {}
        if done.any():
            fo = packed[:, d:2 * d].reshape((B,) + self._obs_shape)
            final = np.full(B, None, dtype=object)
            final_info = np.full(B, None, dtype=object)
            for i in np.flatnonzero(done):
                final[i] = fo[i]
                final_info[i] = {}
            infos = {
                # gymnasium >= 1.0
                "final_obs": final, "_final_obs": done,
                "final_info": final_info, "_final_info": done,
                # gymnasium 0.29 / SB3 VecEnv
                "final_observation": final, "_final_observation": done,
            }
        return obs_out, reward, term, trunc, infos
