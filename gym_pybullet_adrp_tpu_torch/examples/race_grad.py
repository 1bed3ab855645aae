"""Gradient-based trajectory optimization through the race stack.

Counterpart of examples/race_grad.py. Autograd differentiates the
general race env's eager step (envs/race_rl.rl_race_step without
``fast``): FULLSTATE command processing, the Mellinger firmware law with
its biquad filters and tick gating, power distribution, and 20 physics
substeps per control step; plain Adam on the exact gradients optimizes an
action plan. The hand-written kernels (the ``fast`` routes) have no
backward and refuse autograd.

The plan is a K-step sequence of FULLSTATE position offsets (the RL action
convention); the loss pulls the drone through the first gate (a waypoint
0.3 m beyond the gate plane) with a small effort penalty. Every rollout
starts from the same reset and sees the same disturbances, drawn once
from the seed (the JAX package resets from one key, whose stream draws
the same noise each time), on the CPU whatever the device. Each step is
checkpointed with its noise drawn before it (``torch.utils.checkpoint``
restores the global RNG state, not a ``torch.Generator``'s).

    python -m gym_pybullet_adrp_tpu_torch.examples.race_grad --iters 200 \\
        --horizon 25
"""

import argparse
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..envs import race as race_mod
from ..envs import race_rl
from ..rl.ppo import ClipAdam
from ..utils.config import load_config
from ..utils.constants import GATE_Z_LOW, GATE_Z_TALL
from ..utils.enums import Physics, RaceMode


def gate_waypoint(track):
    """The point 0.3 m beyond gate 0's plane, on the side away from the
    start (race_grad.py:49-61)."""
    gate = np.asarray(track.gates_nominal[0], dtype=np.float64)
    yaw = gate[5]
    normal = np.array([-np.sin(yaw), np.cos(yaw), 0.0])
    center = gate[:3].copy()
    center[2] = GATE_Z_TALL if gate[6] == 0 else GATE_Z_LOW
    start = np.asarray(track.init_pos[0])
    if np.dot(start - center, normal) > 0:
        normal = -normal
    return (center + 0.3 * normal).astype(np.float32)


def _step(spec, track, state, action, noise):
    state, *_ = race_rl.rl_race_step(spec, track, state, action,
                                     noise=noise)
    return state, state.race.phys.pos[:, 0]


def rollout(spec, track, start, actions, noise):
    """The plan ``actions`` (K, B, 4) in [-1, 1] from ``start``, each step
    checkpointed while autograd records; returns (final state, positions
    of drone 0 (K, B, 3))."""
    state, traj = start, []
    for k in range(actions.shape[0]):
        a = actions[k][:, None]
        if torch.is_grad_enabled():
            # the step's draws come in ``noise``: no RNG state to restore
            state, pos = checkpoint(_step, spec, track, state, a, noise[k],
                                    use_reentrant=False,
                                    preserve_rng_state=False,
                                    determinism_check="none")
        else:
            state, pos = _step(spec, track, state, a, noise[k])
        traj.append(pos)
    return state, torch.stack(traj)


def plan_loss(traj, actions, waypoint):
    """Closest approach plus end distance to the waypoint, plus a small
    effort penalty (race_grad.py:76-81); per env (B,)."""
    # sqrt(. + eps): a finite gradient where the trajectory hits it
    d = torch.sqrt(torch.sum((traj - waypoint) ** 2, dim=-1) + 1e-8)
    return (d.min(dim=0).values + d[-1]
            + 1e-3 * torch.sum(torch.tanh(actions) ** 2, dim=(0, 2)))


def _to(tree, dev):
    """A NamedTuple of tensors (or None leaves) on ``dev``."""
    return type(tree)(*(None if x is None else x.to(dev) for x in tree))


def setup(config="twogates", seed=0, device="cuda", horizon=0):
    """(spec, track tensors, start state, waypoint, the disturbances of
    ``horizon`` steps) of one drone on ``config``. The reset and the
    disturbances are drawn from a CPU generator on every device, so a
    seed gives the card and the CPU the same plan problem."""
    dev = torch.device(device)
    cfg = load_config(config)
    spec = race_mod.RaceSpec.from_config(cfg, 1, RaceMode.COMPARE,
                                         physics=Physics.PYB)
    track = race_mod.track_from_config(cfg, 1)
    gen = torch.Generator().manual_seed(seed)
    draws = _to(race_mod.sample_reset_draws(spec, 1, gen, "cpu"), dev)
    start = race_rl.rl_race_reset(spec, track, 1, draws, device=dev)
    noise = [race_mod.sample_tick_noise(spec, 1, gen, "cpu")
             for _ in range(horizon)]
    noise = [None if n is None else _to(n, dev) for n in noise]
    waypoint = torch.as_tensor(gate_waypoint(track), device=dev)
    return (spec, race_mod.track_tensors(track, dev), start, waypoint,
            noise)


def run(iters=200, horizon=25, lr=0.05, config="twogates", seed=0,
        verbose=True, device="cuda"):
    """Optimize the plan; returns (losses, gates passed by the optimized
    plan, its closest approach to the waypoint)."""
    spec, track, start, waypoint, noise = setup(config, seed, device,
                                                horizon)
    actions = torch.zeros((horizon, 1, 4), device=waypoint.device,
                          requires_grad=True)
    # 25 control steps = 500 firmware ticks of BPTT: clip the exploding
    # tail of the gradient spectrum, zero isolated NaN cotangents
    tx = ClipAdam(lr, 1.0, eps=1e-8)    # optax.clip_by_global_norm + adam
    opt = tx.init([actions])

    t0 = time.time()
    losses = []
    for it in range(iters):
        _, traj = rollout(spec, track, start, torch.tanh(actions), noise)
        loss = plan_loss(traj, actions, waypoint).sum()
        g, = torch.autograd.grad(loss, actions)
        g = torch.where(torch.isnan(g), 0.0, g)     # optax.zero_nans
        (update,), opt = tx.update([g], opt)
        with torch.no_grad():
            actions += update
        losses.append(float(loss.detach()))
        if verbose and (it % 20 == 0 or it == iters - 1):
            print(f"[{it:4d}] loss {losses[-1]:8.4f}")

    with torch.no_grad():
        st, traj = rollout(spec, track, start, torch.tanh(actions), noise)
    gates_passed = int(st.race.current_gate[0, 0])
    closest = float(torch.linalg.norm(traj - waypoint, dim=-1).min())
    if verbose:
        print(f"optimized plan: gates passed {gates_passed}, closest "
              f"approach to the beyond-gate waypoint {closest:.3f} m "
              f"({time.time() - t0:.1f} s)")
    return losses, gates_passed, closest


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--horizon", type=int, default=25)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--config", default="twogates")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(iters=args.iters, horizon=args.horizon, lr=args.lr,
        config=args.config, device=args.device)
