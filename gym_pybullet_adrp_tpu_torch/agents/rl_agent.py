"""Learned racer: a trained actor-critic policy artifact behind the
controller interface.

Capability parity with reference user_controller/RLController.py:14-81;
the port's copy of the repo's agents/rl_agent.py. It reads the same
flax-msgpack artifacts (``agents/*.msgpack``) through the port's reader
(rl/checkpoint.py) and runs ``ActorCritic`` on ``device``: the caller's,
else the ``"device"`` entry of ``initial_info`` (sim.py puts the env's
there), else the card. The action transform mirrors the reference:
[-1, 1]^4 scaled and added to the current pose as a FULLSTATE command.
"""

from pathlib import Path

import numpy as np
import torch

from .base import BaseController
from ..rl import checkpoint as ckpt
from ..utils.enums import Command
from ..utils.utils import map2pi

ACTION_SCALE = np.array([1.0, 1.0, 1.0, np.pi])
# the shipped policy artifacts, beside the repo's own agents
REPO_AGENTS = Path(__file__).resolve().parents[2] / "agents"


class RLController(BaseController):
    """Policy-driven controller (reference RLController:14-81)."""

    def __init__(self, drone_id, initial_obs, initial_info,
                 buffer_size: int = 100, verbose: bool = False,
                 model_path: str = None, device=None):
        super().__init__(drone_id, initial_obs, initial_info, buffer_size,
                         verbose)
        path = Path(model_path or REPO_AGENTS / "example_race_policy.msgpack")
        if not path.exists():
            raise FileNotFoundError(
                f"no trained model at {path}; train one with "
                "gym_pybullet_adrp_tpu_torch.train_race")
        self.device = torch.device(
            device or (initial_info or {}).get("device", "cuda"))
        self.network = ckpt.load_policy(path, self.device).eval()
        obs_dim = int(np.asarray(initial_obs).size)
        if self.network.obs_dim != obs_dim:
            raise ValueError(f"{path}: a policy of {self.network.obs_dim} "
                             f"obs channels, the env gives {obs_dim}")

    @torch.no_grad()
    def predict(self, obs, reward=None, done=None, info=None, ep_time=None):
        """Deterministic policy action -> FULLSTATE command (reference
        predict:39-73: yaw action zeroed, scaled offset added to the
        current [x, y, z, yaw] pose)."""
        x = torch.as_tensor(np.asarray(obs, dtype=np.float32)[None],
                            device=self.device)
        mean, _, _ = self.network(x)
        action = np.clip(mean[0].cpu().numpy(), -1.0, 1.0)
        action[3] = 0.0
        pose = np.asarray([obs[0], obs[1], obs[2], obs[5]])
        target = pose + action * ACTION_SCALE
        target[3] = map2pi(target[3])
        return Command.FULLSTATE, [
            target[:3], np.zeros(3), np.zeros(3), float(target[3]),
            np.zeros(3), ep_time,
        ]


Controller = RLController
