"""Analytic policy gradients: train hover by BPTT through the simulator.

Counterpart of examples/apg.py. The simulator (rigid-body physics, motor
model, the RL env) is plain PyTorch on the eager path, so autograd
differentiates it end to end: instead of estimating policy gradients from
sampled returns (PPO), backpropagate the task loss through the rolled-out
dynamics and update the policy with exact first-order gradients.

Each rollout step is wrapped in ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint``), so BPTT over ``horizon x 8`` physics
substeps recomputes each step's activations in the backward pass instead
of storing them. Adam is optax's ``adam(lr)`` (eps 1e-8). The env runs
``envs/rl.rl_step``, which launches none of the hand-written kernels
(they have no backward).

    python -m gym_pybullet_adrp_tpu_torch.examples.apg --iters 150 \\
        --horizon 60
"""

import argparse
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..envs import rl as rlenv
from ..envs.core import AviaryConfig
from ..models.drone import drone_params
from ..models.policy import ActorCritic
from ..rl.ppo import ClipAdam
from ..utils.enums import ActionType, DroneModel

RL_CFG = rlenv.RLConfig(aviary=AviaryConfig(ctrl_freq=30),
                        act_type=ActionType.RPM)
INIT_XYZS = np.array([[0.0, 0.0, 0.1125]])
INIT_RPYS = np.zeros((1, 3))
TARGET = (0.0, 0.0, 1.0)
# start offsets along z, one per env and iteration (apg.py:77-80)
DZ_RANGE = (-0.05, 0.3)


def step_cost(net, params, state, target):
    """One differentiable env step with the policy in the loop (apg.py:
    58-72) for B envs: (state', per-env cost (B,))."""
    B = state.action_buffer.shape[0]
    obs = rlenv.compute_obs(RL_CFG, state).reshape(B, -1)
    mean, _, _ = net(obs)
    action = torch.tanh(mean).reshape(B, 1, RL_CFG.act_size)
    state, _, _, _, _ = rlenv.rl_step(RL_CFG, params, state, action)
    ph = state.core.phys
    pos, rpy = ph.pos[:, 0], ph.rpy[:, 0]
    cost = (torch.sum((pos - target) ** 2, dim=-1)
            + 0.1 * torch.sum(ph.vel[:, 0] ** 2, dim=-1)
            + 0.1 * torch.sum(rpy[:, :2] ** 2, dim=-1)
            + 1e-3 * torch.sum(action[:, 0] ** 2, dim=-1))
    return state, cost


def start_state(dz, device):
    """B fresh envs lifted by ``dz`` (B,) along z."""
    st = rlenv.rl_reset(RL_CFG, INIT_XYZS, INIT_RPYS, dz.shape[0],
                        device=device)
    ph = st.core.phys
    lift = torch.stack([torch.zeros_like(dz), torch.zeros_like(dz), dz],
                       dim=-1)[:, None]
    return st._replace(core=st.core._replace(
        phys=ph._replace(pos=ph.pos + lift)))


def rollout(net, params, state, horizon):
    """``horizon`` policy steps; returns (final state, costs (horizon,
    B)). Under autograd every step is checkpointed."""
    target = torch.tensor(TARGET, dtype=state.core.phys.pos.dtype,
                          device=state.core.phys.pos.device)
    costs = []
    for _ in range(horizon):
        if torch.is_grad_enabled():
            # the step draws no random numbers: no RNG state to restore
            state, cost = checkpoint(step_cost, net, params, state, target,
                                     use_reentrant=False,
                                     preserve_rng_state=False,
                                     determinism_check="none")
        else:
            state, cost = step_cost(net, params, state, target)
        costs.append(cost)
    return state, torch.stack(costs)


def loss_fn(net, params, dz, horizon):
    """The batch's BPTT loss (apg.py:74-95): the mean over envs and steps
    of the step costs, from starts lifted by ``dz`` (B,)."""
    _, costs = rollout(net, params, start_state(dz, dz.device), horizon)
    return costs.mean()


def run(iters=150, horizon=60, n_envs=256, lr=0.01, seed=0, device="cuda",
        verbose=True):
    """Train; returns (losses per iteration, final distance to the hover
    target of a fresh rollout from the nominal start)."""
    dev = torch.device(device)
    params = drone_params(DroneModel.CF2X, device=dev)
    net = ActorCritic(RL_CFG.obs_size, RL_CFG.act_size,
                      generator=torch.Generator().manual_seed(seed)).to(dev)
    weights = list(net.parameters())
    tx = ClipAdam(lr, None, eps=1e-8)   # optax.adam(lr)
    opt = tx.init(weights)
    # the start offsets come from a CPU generator on every device, so a
    # seed gives the card and the CPU the same starts
    gen = torch.Generator().manual_seed(seed + 1)

    t0 = time.time()
    losses = []
    for it in range(iters):
        dz = (torch.rand(n_envs, generator=gen)
              * (DZ_RANGE[1] - DZ_RANGE[0]) + DZ_RANGE[0]).to(dev)
        loss = loss_fn(net, params, dz, horizon)
        # the value head and log_std take no part in the loss: a zero
        # gradient, as jax.grad gives them
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(weights, torch.autograd.grad(
                     loss, weights, allow_unused=True))]
        updates, opt = tx.update(grads, opt)
        with torch.no_grad():
            for w, u in zip(weights, updates):
                w.add_(u)
        losses.append(float(loss.detach()))
        if verbose and (it % 10 == 0 or it == iters - 1):
            rate = (it + 1) * n_envs * horizon / (time.time() - t0)
            print(f"[{it:4d}] bptt loss {losses[-1]:9.4f}  "
                  f"({rate:,.0f} env-steps/s)")

    # evaluate: final distance to the hover target after a fresh rollout
    with torch.no_grad():
        st = rlenv.rl_reset(RL_CFG, INIT_XYZS, INIT_RPYS, 1, device=dev)
        st, _ = rollout(net, params, st, horizon)
        dist = float(torch.linalg.norm(
            st.core.phys.pos[0, 0] - torch.tensor(TARGET, device=dev)))
    if verbose:
        print(f"final distance to target after {horizon} steps: "
              f"{dist:.4f} m")
    return losses, dist


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--horizon", type=int, default=60)
    ap.add_argument("--n_envs", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(iters=args.iters, horizon=args.horizon, n_envs=args.n_envs,
        lr=args.lr, device=args.device)
