"""Actor-critic policy network.

Counterpart of gym_pybullet_adrp_tpu.models.policy (``ActorCritic`` :20,
``sample_action`` :89, ``gaussian_logp`` :96): separate tanh towers for
policy and value (the SB3 MlpPolicy layout), a Gaussian head with a
state-independent log-std. The forward is plain ``nn.Linear``: the JAX
evaluation path runs it in XLA outside any Pallas kernel, and its
matmuls are small.
"""

import math
from typing import Sequence

import torch
from torch import nn


class ActorCritic(nn.Module):
    """Separate pi/vf towers + Gaussian actor head."""

    def __init__(self, obs_dim: int, act_dim: int = 4,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.hidden = tuple(hidden)
        widths = (obs_dim,) + self.hidden
        self.pi = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1]) for i in range(len(hidden))
        )
        self.pi_out = nn.Linear(widths[-1], act_dim)
        self.vf = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1]) for i in range(len(hidden))
        )
        self.vf_out = nn.Linear(widths[-1], 1)
        self.log_std = nn.Parameter(torch.zeros(act_dim))

    def forward(self, obs):
        """obs (..., obs_dim) -> (mean (..., act_dim), log_std (act_dim,),
        value (...,))."""
        x = obs
        for layer in self.pi:
            x = torch.tanh(layer(x))
        mean = self.pi_out(x)
        v = obs
        for layer in self.vf:
            v = torch.tanh(layer(v))
        value = self.vf_out(v).squeeze(-1)
        return mean, self.log_std, value


def gaussian_logp(action, mean, log_std):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return torch.sum(
        -0.5 * (z * z + 2 * log_std + math.log(2 * math.pi)), dim=-1
    )


def sample_action(mean, log_std, generator=None):
    """Gaussian sample around ``mean`` with the head's std, and its
    log-probability. Draws from ``generator`` (a torch.Generator on the
    tensors' device) rather than a JAX key."""
    noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                        device=mean.device)
    action = mean + torch.exp(log_std) * noise
    return action, gaussian_logp(action, mean, log_std)
