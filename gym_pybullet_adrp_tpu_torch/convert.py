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
  module with the weights of a port ``ActorCritic`` (numpy float32);
  ``actor_critic_flax_names`` maps each port parameter to its flax leaf.
* ``cnn_actor_critic_from_flax`` / ``flax_from_cnn_actor_critic``: the
  same for ``CnnActorCritic``. A flax Conv ``kernel`` is (kh, kw, cin,
  cout), a ``Conv2d.weight`` (cout, cin, kh, kw): ``weight =
  kernel.permute(3, 2, 0, 1)``. The frame size is an argument:
  ``Dense_0``'s input width alone does not fix H and W.
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
from .models.policy import ActorCritic, CnnActorCritic
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


def actor_critic_flax_names(net: ActorCritic):
    """{parameter name of the port's ``ActorCritic``: (flax module, leaf)}
    of the flax tree: ``Dense_i`` in layer order (pi tower, its head, vf
    tower, its head); a weight is its ``kernel`` transposed."""
    layers = ([f"pi.{i}" for i in range(len(net.hidden))] + ["pi_out"]
              + [f"vf.{i}" for i in range(len(net.hidden))] + ["vf_out"])
    names = {"log_std": ("log_std", None)}
    for i, layer in enumerate(layers):
        names[f"{layer}.weight"] = (f"Dense_{i}", "kernel")
        names[f"{layer}.bias"] = (f"Dense_{i}", "bias")
    return names


def _np32(t):
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _copy(param, x, name):
    x = np.array(x, dtype=np.float32, order="C")
    if x.shape != tuple(param.shape):
        raise ValueError(f"{name}: {x.shape} does not fit "
                         f"{tuple(param.shape)}")
    param.copy_(torch.from_numpy(x))


def cnn_actor_critic_from_flax(params, img_h: int,
                               img_w: int) -> CnnActorCritic:
    """Port a flax CnnActorCritic params tree ({"params": {"Conv_i",
    "Dense_i", "log_std"}}) for frames of ``img_h`` x ``img_w``; channels,
    feature width and action size are read from the kernels."""
    p = params["params"] if "params" in params else params
    if "Conv_0" not in p:
        raise ValueError(f"not a CnnActorCritic params tree: {sorted(p)}")
    k0 = np.asarray(p["Conv_0"]["kernel"])
    net = CnnActorCritic(act_dim=np.asarray(p["Dense_1"]["kernel"]).shape[1],
                         img_h=img_h, img_w=img_w, img_c=k0.shape[2],
                         features=np.asarray(p["Dense_0"]["kernel"]).shape[1])
    with torch.no_grad():
        for i, conv in enumerate(net.convs):
            k = np.asarray(p[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1)
            _copy(conv.weight, k, f"Conv_{i}.kernel")
            _copy(conv.bias, p[f"Conv_{i}"]["bias"], f"Conv_{i}.bias")
        for i, layer in enumerate(net.dense_layers()):
            _copy(layer.weight, np.asarray(p[f"Dense_{i}"]["kernel"]).T,
                  f"Dense_{i}.kernel")
            _copy(layer.bias, p[f"Dense_{i}"]["bias"], f"Dense_{i}.bias")
        _copy(net.log_std, p["log_std"], "log_std")
    return net


def flax_from_cnn_actor_critic(net: CnnActorCritic):
    """The flax CnnActorCritic params tree of ``net``, as float32 numpy
    arrays."""
    p = {f"Conv_{i}": {"kernel": np.ascontiguousarray(
        _np32(conv.weight).transpose(2, 3, 1, 0)), "bias": _np32(conv.bias)}
        for i, conv in enumerate(net.convs)}
    p.update({f"Dense_{i}": {"kernel": np.ascontiguousarray(
        _np32(layer.weight).T), "bias": _np32(layer.bias)}
        for i, layer in enumerate(net.dense_layers())})
    p["log_std"] = _np32(net.log_std)
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
