"""Evaluate a trained race policy: gates passed, completion rate, lap time.

Counterpart of scripts/eval_race.py (``evaluate`` :29): deterministic
(mean-action) or stochastic rollouts of a shipped policy over a batch of
envs on the row env's fused step, with the same metrics dict. Race
accounting is read from the step's pre-autoreset telemetry rows: gates
passed per drone is the ``current_gate`` at the end of the env's first
episode, completion its ``finished`` flag, and the lap time
``(fin_step + 1) * 20 / 500`` seconds from the first step whose
``finished`` row is set.

Usage:
  python -m gym_pybullet_adrp_tpu_torch.eval_race \\
      --policy results/level1_robust.msgpack --config level1 --device cuda
"""

import argparse

import numpy as np
import torch

from .envs import race as race_mod
from .envs.race_rl_rowfast import make_row_env
from .models.policy import ActorCritic, sample_action
from .rl import checkpoint as ckpt
from .utils.config import load_config
from .utils.enums import Physics, RaceMode


def make_eval_env(config_name, n_envs, device, seed=42, n_drones=1,
                  fused=True):
    """The row env an evaluation drives: per-drone reward, telemetry on,
    draws from a generator on ``device`` seeded with ``seed``; ``fused``
    picks the race_step kernel or race_window + the plain tail."""
    cfg = load_config(config_name)
    mode = RaceMode.COMPETE if n_drones > 1 else RaceMode.COMPARE
    spec = race_mod.RaceSpec.from_config(cfg, n_drones, mode, Physics.PYB)
    track = race_mod.track_from_config(cfg, n_drones)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return make_row_env(spec, track, n_envs, device=device, generator=gen,
                        per_drone_reward=True, telemetry=True, fused=fused)


@torch.no_grad()
def rollout(net: ActorCritic, env, n_steps, stochastic=False, state=None,
            obs=None):
    """Fly ``net`` for ``n_steps`` steps from a reset (or from ``state``
    with its ``obs``). Returns (current_gate, finished, eliminated) as
    (n_steps, B, N) tensors, done (n_steps, B), and the final
    (state, obs)."""
    B, N = env.n_envs, env.N
    if state is None:
        state = env.reset()
        obs = env.initial_obs(state)
    cgs, fins, els, dones = [], [], [], []
    for _ in range(n_steps):
        flat = obs.reshape(B * N, -1)
        mean, log_std, _ = net(flat)
        act = (sample_action(mean, log_std, env.generator)[0]
               if stochastic else mean)
        act = torch.clamp(act, -1.0, 1.0)
        act = act.reshape(B, N, 4) if N > 1 else act
        state, obs, _, done, info = env.step(state, act)
        cgs.append(info["current_gate"].reshape(B, N))
        fins.append(info["finished"].reshape(B, N))
        els.append(info["eliminated"].reshape(B, N))
        dones.append(done)
    return (torch.stack(cgs), torch.stack(fins), torch.stack(els),
            torch.stack(dones), state, obs)


def race_metrics(cgs, fins, els, dones, num_gates, steps_per_ctrl,
                 pyb_freq):
    """First-episode race metrics from (T, B, N) telemetry (numpy)."""
    ep_steps = dones.shape[0]
    B = dones.shape[1]
    fins, els = fins > 0.5, els > 0.5
    first_done = np.where(
        dones.any(axis=0), dones.argmax(axis=0), ep_steps - 1
    )
    env_i = np.arange(B)
    gates = cgs[first_done, env_i, :]
    has_fin = fins[first_done, env_i, :]
    t_idx = np.arange(ep_steps)[:, None, None]
    live = t_idx <= first_done[None, :, None]
    fin_event = fins & live
    first_fin = np.where(
        fin_event.any(axis=0), fin_event.argmax(axis=0), ep_steps + 1
    )
    completed = has_fin.all(axis=1)
    fin_step = first_fin.max(axis=1)
    lap_t = (fin_step + 1) * steps_per_ctrl / pyb_freq
    hist = {g: int((gates.min(axis=1) == g).sum())
            for g in range(num_gates + 1)}
    elim = els[first_done, env_i, :]
    return {
        "gates_hist": hist,
        "completion_rate": float(completed.mean()),
        "per_drone_completion_rate": float(has_fin.mean()),
        "per_drone_elimination_rate": float(elim.mean()),
        "mean_gates_eliminated": (
            float(gates[elim].mean()) if elim.any() else None
        ),
        "mean_gates": float(gates.mean()),
        "mean_lap_time": float(lap_t[completed].mean()) if completed.any()
        else None,
        "best_lap_time": float(lap_t[completed].min()) if completed.any()
        else None,
    }


def evaluate(policy, config_name="getting_started", n_envs=128,
             device="cpu", stochastic=False, seed=42, n_drones=1,
             fused=True):
    """Evaluate ``policy`` (an ``ActorCritic`` or the path of a flax
    artifact) for one full episode horizon; returns the metrics dict of
    scripts/eval_race.evaluate."""
    env = make_eval_env(config_name, n_envs, device, seed, n_drones, fused)
    net = (policy if isinstance(policy, ActorCritic)
           else ckpt.load_policy(policy, device))
    net = net.to(device).eval()
    spec = env.spec
    ep_steps = int(spec.episode_len_sec * spec.pyb_freq
                   / spec.steps_per_ctrl)
    cgs, fins, els, dones, _, _ = rollout(net, env, ep_steps, stochastic)
    return race_metrics(cgs.cpu().numpy(), fins.cpu().numpy(),
                        els.cpu().numpy(), dones.cpu().numpy(),
                        spec.num_gates, spec.steps_per_ctrl, spec.pyb_freq)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="results/gs_full_policy.msgpack")
    ap.add_argument("--config", default="getting_started")
    ap.add_argument("--envs", type=int, default=128)
    ap.add_argument("--n_drones", type=int, default=1)
    ap.add_argument("--stochastic", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = evaluate(args.policy, args.config, args.envs, args.device,
                   args.stochastic, args.seed, args.n_drones)
    for k, v in out.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
