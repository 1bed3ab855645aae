"""Carry state and weights across from the JAX package.

* ``row_state_from_numpy`` / ``row_state_to_numpy``: the row env's state
  blocks (the leaves of the JAX ``RowRaceState``, as numpy arrays) to the
  port's ``RowRaceState`` and back. Both sides use the same channel-major
  ``(C, T, 128)`` blocks, so this is ``torch.from_numpy`` per leaf.
* ``actor_critic_from_flax``: a flax ``ActorCritic`` params tree (nested
  dicts of numpy, e.g. from ``rl.checkpoint.load_params``) to the port's
  ``ActorCritic``. A flax Dense ``kernel`` is (in, out); a torch
  ``Linear.weight`` is (out, in), so ``weight = kernel.T``.
"""

import numpy as np
import torch

from .envs.race_rl_rowfast import RowRaceState
from .models.policy import ActorCritic

_LEAVES = ("S", "R", "GG", "OO", "EP")


def row_state_from_numpy(S, R, GG, OO, EP, device="cpu") -> RowRaceState:
    def conv(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return RowRaceState(S=conv(S), R=conv(R), GG=conv(GG), OO=conv(OO),
                        EP=conv(EP))


def row_state_to_numpy(state: RowRaceState):
    """(S, R, GG, OO, EP) as float32 numpy arrays."""
    return tuple(getattr(state, k).detach().cpu().numpy() for k in _LEAVES)


def actor_critic_from_flax(params) -> ActorCritic:
    """Port a flax ActorCritic params tree ({"params": {"Dense_i": ...,
    "log_std": ...}}); the tower widths are read from the kernels."""
    p = params["params"] if "params" in params else params
    n_dense = sum(1 for k in p if k.startswith("Dense_"))
    if n_dense % 2 or n_dense < 4:
        raise ValueError(f"not an ActorCritic params tree: {sorted(p)}")
    H = n_dense // 2 - 1
    kernel = [np.asarray(p[f"Dense_{i}"]["kernel"]) for i in range(n_dense)]
    obs_dim = kernel[0].shape[0]
    hidden = tuple(kernel[i].shape[1] for i in range(H))
    act_dim = kernel[H].shape[1]
    net = ActorCritic(obs_dim, act_dim, hidden)
    layers = (list(net.pi) + [net.pi_out] + list(net.vf) + [net.vf_out])
    with torch.no_grad():
        for i, layer in enumerate(layers):
            w = np.array(p[f"Dense_{i}"]["kernel"], dtype=np.float32)
            b = np.array(p[f"Dense_{i}"]["bias"], dtype=np.float32)
            if tuple(layer.weight.shape) != (w.shape[1], w.shape[0]):
                raise ValueError(f"Dense_{i}: kernel {w.shape} does not fit "
                                 f"{tuple(layer.weight.shape)}")
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
            layer.bias.copy_(torch.from_numpy(b))
        net.log_std.copy_(torch.from_numpy(
            np.array(p["log_std"], dtype=np.float32)))
    return net
