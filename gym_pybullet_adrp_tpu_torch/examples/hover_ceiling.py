"""Hover-PPO return ceiling: the reference's stop threshold is out of reach.

Counterpart of examples/hover_ceiling.py (``analytic_upper_bound`` :37,
``probe_best_return`` :55, ``main`` :110). The reference's stop-training
callback waits for a deterministic evaluation return of 474.15 on
HoverAviary with ONE_D_RPM actions (reference examples/learn.py:78-79).
That threshold lies above what the env's physics allows; this script is
the argument as code:

1. **Analytic upper bound**: ONE_D_RPM limits the rpm to HOVER_RPM * (1
   +- 0.05), a net vertical acceleration in [-0.0975 g, +0.1025 g]
   (reference BaseRLAviary.py:192, thrust ~ rpm^2). Without drag and
   attitude dynamics (both only lower it), the best return is the 8 s x
   30 Hz sum of max(0, 2 - e^4) along the fastest climb from z0 = 0.1125
   to the z = 1 target (reference HoverAviary.py:68-79).
2. **Probe**: a saturated PD controller (bang-bang far from the target, P
   near it) over a 32 x 32 gain grid, every pair one env of one batch of
   the real env (``rl.ppo.hover_adapter`` on ``device``, the card unless
   the caller asks for the CPU); the best return measured.

    python -m gym_pybullet_adrp_tpu_torch.examples.hover_ceiling \\
        [--grid 32] [--device cpu]
"""

import argparse

import numpy as np
import torch


def analytic_upper_bound(z0=0.1125, zt=1.0, ep_sec=8.0, ctrl_hz=30,
                         g=9.8, up=0.1025):
    """Frictionless bound: at time t the error is at least the distance
    to the target less the distance covered under full acceleration from
    rest (no braking: a per-step bound, not one trajectory). Drag and
    attitude dynamics only lower it."""
    a_up = up * g
    d = zt - z0
    dt = 1.0 / ctrl_hz
    # the episode truncates at the first step whose time EXCEEDS ep_sec
    # (reference HoverAviary._computeTruncated:100-117), and that step's
    # reward counts: n = ep_sec * ctrl_hz + 1 rewarded steps
    n = int(ep_sec * ctrl_hz) + 1
    t = np.arange(1, n + 1) * dt
    e_min = np.maximum(0.0, d - 0.5 * a_up * t * t)
    return float(np.sum(np.maximum(0.0, 2.0 - e_min ** 4)))


def probe_best_return(grid=32, n_steps=None, device="cuda"):
    """The best saturated-PD return over a ``grid`` x ``grid`` gain grid
    (kp in [1, 40], kd in [0, 20]) on the real env, one batch of grid^2
    envs, each return summed until the env's first done. Returns (best
    return, kp, kd)."""
    from ..envs import rl as rlenv
    from ..envs.core import AviaryConfig
    from ..models.drone import drone_params
    from ..rl.ppo import PPOConfig, hover_adapter
    from ..utils.enums import ActionType, DroneModel

    n_envs = grid * grid
    kp = torch.linspace(1.0, 40.0, grid,
                        device=device).repeat_interleave(grid)
    kd = torch.linspace(0.0, 20.0, grid, device=device).repeat(grid)
    rl_cfg = rlenv.RLConfig(aviary=AviaryConfig(ctrl_freq=30),
                            act_type=ActionType.ONE_D_RPM)
    params = drone_params(DroneModel.CF2X, device=device)
    adapter = hover_adapter(PPOConfig(n_envs=n_envs), rl_cfg, params,
                            np.array([[0.0, 0.0, 0.1125]]), np.zeros((1, 3)),
                            device=device)
    n_steps = n_steps or (8 * 30 + 2)
    with torch.no_grad():
        env_state, obs = adapter.batched_reset()
        ret = torch.zeros(n_envs, device=device)
        done_seen = torch.zeros(n_envs, dtype=torch.bool, device=device)
        for _ in range(n_steps):
            z, vz = obs[:, 2], obs[:, 8]
            a = torch.clamp(kp * (1.0 - z) - kd * vz, -1.0, 1.0)[:, None]
            env_state, obs, reward, done = adapter.step(env_state, a)
            ret = ret + torch.where(done_seen, 0.0, reward)
            done_seen = done_seen | done
    rets = ret.cpu().numpy()
    i = int(np.argmax(rets))
    return float(rets[i]), float(kp[i]), float(kd[i])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ub = analytic_upper_bound()
    best, kp, kd = probe_best_return(args.grid, device=args.device)
    print(f"analytic upper bound (frictionless): {ub:.2f}")
    print(f"probe best return (kp={kp:.2f}, kd={kd:.2f}): {best:.2f}")
    print("reference stop threshold            : 474.15")
    print(f"threshold attainable: {474.15 <= ub}")
    return ub, best, kp, kd


if __name__ == "__main__":
    main()
