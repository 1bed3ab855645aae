"""Actor-critic policy network.

Counterpart of gym_pybullet_adrp_tpu.models.policy (``ActorCritic`` :20,
``CnnActorCritic`` :48, ``sample_action`` :89, ``gaussian_logp`` :96,
``gaussian_entropy`` :102): separate tanh towers for policy and value
(the SB3 MlpPolicy layout), a Gaussian head with a state-independent
log-std; and its pixel counterpart, a shared conv extractor with the same
heads. The forwards are plain ``nn.Linear``/``F.conv2d``: the JAX package
runs them in XLA outside any Pallas kernel (for evaluation and in the PPO
learner). The rollout's in-kernel forward is ops/race_step's policy pack.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class ActorCritic(nn.Module):
    """Separate pi/vf towers + Gaussian actor head, initialised as the
    flax module: orthogonal weights with gain sqrt(2) in the hidden
    layers, 0.01 on the policy head and 1.0 on the value head, zero biases
    and log_std. ``generator`` (a CPU ``torch.Generator``) draws the
    weights; a flax Dense draws them from a jax key, so the two inits are
    alike in law, not in value."""

    def __init__(self, obs_dim: int, act_dim: int = 4,
                 hidden: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None):
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
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw fresh weights from ``generator`` (zero biases, log-std)."""
        gains = ([math.sqrt(2.0)] * len(self.hidden) + [0.01]
                 + [math.sqrt(2.0)] * len(self.hidden) + [1.0])
        layers = (list(self.pi) + [self.pi_out] + list(self.vf)
                  + [self.vf_out])
        with torch.no_grad():
            for layer, gain in zip(layers, gains):
                nn.init.orthogonal_(layer.weight, gain, generator=generator)
                layer.bias.zero_()
            self.log_std.zero_()

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


def same_pads(n: int, k: int, s: int):
    """(low, high) padding of one axis of length ``n`` under flax's
    ``padding="SAME"`` at kernel ``k`` and stride ``s``: the output is
    ceil(n / s) long, the total padding max((out - 1) s + k - n, 0), its
    smaller half first (asymmetric where the total is odd; torch's
    ``padding="same"`` refuses stride > 1)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class CnnActorCritic(nn.Module):
    """Pixel actor-critic (the flax ``CnnActorCritic``): three ReLU convs
    (16 channels k5 s2, 32 k3 s2, 64 k3 s2, flax "SAME" padding), a
    256-wide ReLU dense layer, then the mean and value heads and a zero
    log-std. The input is the flat (H, W, C) pixel observation in [0, 1];
    the last conv's output is flattened in H, W, C order, as flax's, so a
    flax ``Dense_0`` kernel is the dense layer's weight transposed. Init as
    flax's: orthogonal, gain sqrt(2) in the trunk, 0.01 on the mean head,
    1.0 on the value head, zero biases; ``generator`` draws the weights
    (alike in law to flax's, not in value)."""

    LAYERS = ((16, 5, 2), (32, 3, 2), (64, 3, 2))

    def __init__(self, act_dim: int, img_h: int = 24, img_w: int = 32,
                 img_c: int = 3, features: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act_dim, self.features = act_dim, features
        self.img = (img_h, img_w, img_c)
        self.obs_dim = img_h * img_w * img_c
        convs, pads = [], []
        h, w, c = img_h, img_w, img_c
        for ch, k, s in self.LAYERS:
            convs.append(nn.Conv2d(c, ch, k, stride=s))
            (h0, h1), (w0, w1) = same_pads(h, k, s), same_pads(w, k, s)
            pads.append((w0, w1, h0, h1))
            h, w, c = -(-h // s), -(-w // s), ch
        self.convs = nn.ModuleList(convs)
        self.pads = tuple(pads)
        self.dense = nn.Linear(h * w * c, features)
        self.mean_head = nn.Linear(features, act_dim)
        self.value_head = nn.Linear(features, 1)
        self.log_std = nn.Parameter(torch.zeros(act_dim))
        self.reset_parameters(generator)

    def dense_layers(self):
        """The dense layers in flax's order (Dense_0, Dense_1, Dense_2)."""
        return [self.dense, self.mean_head, self.value_head]

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw fresh weights from ``generator`` (zero biases, log-std)."""
        layers = list(self.convs) + self.dense_layers()
        gains = [math.sqrt(2.0)] * 4 + [0.01, 1.0]
        with torch.no_grad():
            for layer, gain in zip(layers, gains):
                nn.init.orthogonal_(layer.weight, gain, generator=generator)
                layer.bias.zero_()
            self.log_std.zero_()

    def forward(self, obs):
        """obs (..., H*W*C) -> (mean (..., act_dim), log_std (act_dim,),
        value (...,))."""
        h, w, c = self.img
        lead = obs.shape[:-1]
        x = obs.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        for conv, pad in zip(self.convs, self.pads):
            x = F.relu(conv(F.pad(x, pad)))
        x = x.permute(0, 2, 3, 1).reshape(lead + (-1,))
        feat = F.relu(self.dense(x))
        value = self.value_head(feat).squeeze(-1)
        return self.mean_head(feat), self.log_std, value


def gaussian_logp(action, mean, log_std):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return torch.sum(
        -0.5 * (z * z + 2 * log_std + math.log(2 * math.pi)), dim=-1
    )


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))


def sample_action(mean, log_std, generator=None):
    """Gaussian sample around ``mean`` with the head's std, and its
    log-probability. Draws from ``generator`` (a torch.Generator on the
    tensors' device) rather than a JAX key."""
    noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                        device=mean.device)
    action = mean + torch.exp(log_std) * noise
    return action, gaussian_logp(action, mean, log_std)
