"""Evaluate a camera-based (pixels-to-actions) race policy, on the card.

Counterpart of scripts/eval_race_rgb.py (``evaluate`` :20): mean-action
(or sampled) rollouts of a ``CnnActorCritic`` over B envs of the general
race env (one drone), each step's frames ray-cast from the post-step
state (envs/race_rl.compute_rgb_obs), with the JAX script's metrics
dict. Gates and finishes are read from the pre-autoreset telemetry of
``race_rl.batched_rl_race_step``: an env's best gate before its first
episode ends, and its first finishing step. As in the JAX script, the
lap time is that step's index over the control rate (scripts/eval_race.py
and this package's eval_race count one step more). The loop stops once
every env's first episode has ended: nothing it reads changes after.

Usage:
  python -m gym_pybullet_adrp_tpu_torch.eval_race_rgb \\
      --policy results/px5/full.msgpack --config getting_started \\
      --img 64x48 --fov 110 --camera velocity
"""

import argparse
import json

import torch

from .envs import race as race_mod
from .envs import race_rl
from .models.policy import CnnActorCritic
from .rl import checkpoint as ckpt
from .utils.config import load_config
from .utils.enums import Physics, RaceMode


@torch.no_grad()
def evaluate(policy_path, config_name="getting_started", n_envs=128,
             img="64x48", fov=110.0, camera="velocity", seed=42,
             max_steps=None, stochastic=False, device="cuda"):
    """Evaluate the pixel policy at ``policy_path`` (or a
    ``CnnActorCritic``) on ``n_envs`` envs of ``config_name`` on
    ``device`` (the card unless the caller asks for the CPU) for one
    episode horizon, or ``max_steps``; returns the JAX script's dict
    (gates_hist, completion_rate, mean_gates, mean_lap_time, img, fov,
    camera) and the number of steps run."""
    device = torch.device(device)
    cfg = load_config(config_name)
    spec = race_mod.RaceSpec.from_config(cfg, 1, RaceMode.COMPARE,
                                         Physics.PYB)
    track = race_mod.track_tensors(race_mod.track_from_config(cfg, 1),
                                   device)
    W, H = (int(x) for x in img.split("x"))
    net = (policy_path if isinstance(policy_path, CnnActorCritic)
           else ckpt.load_policy(policy_path, device, img=(H, W)))
    net = net.to(device).eval()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    B = n_envs
    st = race_rl.rl_race_reset(spec, track, B, generator=gen, device=device)

    def frames(st):
        return race_rl.compute_rgb_obs(spec, st, W, H, fov, camera)

    obs = frames(st)
    best_gate = torch.zeros(B, dtype=torch.int32, device=device)
    done_seen = torch.zeros(B, dtype=torch.bool, device=device)
    fin_step = torch.full((B,), -1, dtype=torch.int32, device=device)
    T = max_steps or int(spec.episode_len_sec * spec.ctrl_freq)
    for t in range(T):
        mean, log_std, _ = net(obs)
        act = mean
        if stochastic:
            act = mean + torch.exp(log_std) * torch.randn(
                mean.shape, generator=gen, device=device, dtype=mean.dtype)
        a = torch.clamp(act, -1.0, 1.0).reshape(B, 1, 4)
        st, _, _, te, tr, telem = race_rl.batched_rl_race_step(
            spec, track, st, a, generator=gen, telemetry=True)
        gate = telem["current_gate"][:, 0].to(torch.int32)
        fin = telem["finished"][:, 0]
        live = ~done_seen
        best_gate = torch.maximum(best_gate, torch.where(live, gate, 0))
        fin_step = torch.where(live & fin & (fin_step < 0), t, fin_step)
        done_seen = done_seen | te | tr
        if bool(done_seen.all()):
            break
        obs = frames(st)
    best_gate, fin_step = best_gate.cpu(), fin_step.cpu()
    G = spec.num_gates
    laps = fin_step[fin_step >= 0].double() / spec.ctrl_freq
    return {
        "gates_hist": {str(g): int((best_gate == g).sum())
                       for g in range(G + 1)},
        "completion_rate": float((best_gate >= G).double().mean()),
        "mean_gates": float(best_gate.double().mean()),
        "mean_lap_time": float(laps.mean()) if laps.numel() else None,
        "img": img, "fov": fov, "camera": camera,
        "steps": t + 1,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=(
        argparse.RawDescriptionHelpFormatter))
    ap.add_argument("--policy", required=True)
    ap.add_argument("--config", default="getting_started")
    ap.add_argument("--envs", type=int, default=128)
    ap.add_argument("--img", default="64x48")
    ap.add_argument("--fov", type=float, default=110.0)
    ap.add_argument("--camera", default="velocity",
                    choices=["body", "velocity"])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--stochastic", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = evaluate(args.policy, args.config, args.envs, args.img, args.fov,
                   args.camera, args.seed, args.max_steps, args.stochastic,
                   args.device)
    out["stochastic"] = args.stochastic
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
