"""Carry state and weights across from the JAX package.

* ``row_state_from_numpy`` / ``row_state_to_numpy``: the row env's state
  blocks (the leaves of the JAX ``RowRaceState``, as numpy arrays) to the
  port's ``RowRaceState`` and back. Both sides use the same channel-major
  ``(C, T, 128)`` blocks, so this is ``torch.from_numpy`` per leaf.
* ``actor_critic_from_flax``: a flax ``ActorCritic`` params tree (nested
  dicts of numpy, e.g. from ``rl.checkpoint.load_params``) to the port's
  ``ActorCritic``. A flax Dense ``kernel`` is (in, out); a torch
  ``Linear.weight`` is (out, in), so ``weight = kernel.T``.
* ``flax_from_actor_critic``: its inverse, the params tree of the flax
  module with the weights of a port ``ActorCritic`` (numpy float32).
* The hover env: ``fast_hover_state_from_numpy`` (the packed (13, T, 128)
  state and its step counts), ``phys_state_from_numpy``,
  ``core_state_from_numpy`` and ``rl_state_from_numpy`` (any object with
  the JAX ``PhysState``/``CoreState``/``RLState`` attributes, e.g. a
  vmapped JAX state: leaves carry the batch axis first, as the port's),
  ``drone_params_from_numpy`` (an object with ``DroneParams``' fields),
  ``pid_state_from_numpy`` (the DSL PID controller's state).
"""

import numpy as np
import torch

from .control.dslpid import PIDState
from .envs.core import CoreState
from .envs.fast_hover import FastHoverState
from .envs.race_rl_rowfast import RowRaceState
from .envs.rl import RLState
from .models.drone import DroneParams
from .models.policy import ActorCritic
from .ops.dynamics import PhysState

_LEAVES = ("S", "R", "GG", "OO", "EP")


def row_state_from_numpy(S, R, GG, OO, EP, device="cuda") -> RowRaceState:
    """The port's state from numpy blocks, on ``device`` (the card unless
    the caller asks for the CPU)."""
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


def flax_from_actor_critic(net: ActorCritic):
    """The flax ActorCritic params tree ({"params": {"Dense_i": {"kernel",
    "bias"}, "log_std"}}) of ``net``, as float32 numpy arrays."""
    layers = (list(net.pi) + [net.pi_out] + list(net.vf) + [net.vf_out])

    def np32(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    p = {f"Dense_{i}": {"kernel": np.ascontiguousarray(np32(layer.weight).T),
                        "bias": np32(layer.bias)}
         for i, layer in enumerate(layers)}
    p["log_std"] = np32(net.log_std)
    return {"params": p}


def _f32(x, device):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def _i32(x, device):
    return torch.from_numpy(np.array(x, dtype=np.int32)).to(device)


def fast_hover_state_from_numpy(packed, step_count,
                                device="cuda") -> FastHoverState:
    """The fast hover env's state: the (13, T, 128) float32 block and the
    (T, 128) int32 step counts."""
    return FastHoverState(packed=_f32(packed, device),
                          step_count=_i32(step_count, device))


def phys_state_from_numpy(phys, device="cuda") -> PhysState:
    return PhysState(*(_f32(getattr(phys, k), device)
                       for k in PhysState._fields))


def core_state_from_numpy(core, device="cuda") -> CoreState:
    return CoreState(phys=phys_state_from_numpy(core.phys, device),
                     last_clipped_action=_f32(core.last_clipped_action,
                                              device),
                     step_counter=_i32(core.step_counter, device))


def pid_state_from_numpy(ctl, device="cuda") -> PIDState:
    return PIDState(*(_f32(getattr(ctl, k), device)
                      for k in PIDState._fields))


def rl_state_from_numpy(state, device="cuda") -> RLState:
    return RLState(core=core_state_from_numpy(state.core, device),
                   ctrl=pid_state_from_numpy(state.ctrl, device),
                   action_buffer=_f32(state.action_buffer, device),
                   target_pos=_f32(state.target_pos, device))


def drone_params_from_numpy(params, device="cuda") -> DroneParams:
    return DroneParams(*(_f32(getattr(params, k), device)
                         for k in DroneParams._fields))
