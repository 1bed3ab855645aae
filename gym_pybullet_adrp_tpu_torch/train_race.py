"""Race-policy PPO training, on the card.

Counterpart of scripts/train_race.py with the PPO set-up and loop around
it (:167-190, :356-424), on one of two envs:

* the row env (default; the JAX script's ``--rowfast`` path, :202-261,
  :330-338): envs/race_rl_rowfast.py and, with ``--fuse_policy``, the
  policy forward inside the race kernels: K steps per race_rollout
  launch when ``--kernel_chunk`` divides ``--n_steps``, else one
  race_step launch per step. Without it the policy runs outside
  (``nn.Linear``) and race_step runs once per step.
* the general race env (``--general``; the JAX script without
  ``--rowfast``, :192-200, :340-351): envs/race_rl.py, the commander,
  the Mellinger firmware and the collision tests as eager tensor ops,
  one drone per env. ``--fast`` (which implies ``--general``, as the JAX
  script's ``--fast`` without ``--rowfast`` does) runs each step's
  20-tick firmware window in one launch of the window kernel for all
  envs (envs/race_fast.py).

Not ported yet, and refused with an error: ``--league``,
``--prox_penalty`` and ``--obs rgb``.

Usage:
  python -m gym_pybullet_adrp_tpu_torch.train_race \\
      --config getting_started --n_envs 4096 --fuse_policy
  python -m gym_pybullet_adrp_tpu_torch.train_race --fast --n_envs 4096
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from .envs import race as race_mod
from .envs import race_fast, race_rl
from .envs.race_rl_rowfast import make_policy_rollout, make_row_env
from .rl import checkpoint as ckpt
from .rl.ppo import EnvAdapter, PPOConfig, make_ppo_core
from .utils.config import load_config
from .utils.enums import Physics, RaceMode


def _not_ported(what):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md); "
        "the JAX package's scripts/train_race.py has it")


def train(config="twogates", n_envs=256, iters=200, n_steps=64,
          end_after_gate=2, out=None, init=None, save_every=0,
          shuffle_block=512, ent_coef=None, lr=None, lr_decay=False,
          elim_penalty=1.0, kernel_chunk=16, fuse_policy=False,
          hidden=(64, 64), n_drones=1, compete=False, seed=0,
          device="cuda", log_every=10, general=False, league=None,
          prox_penalty=0.0, obs="kin", fast=False):
    """Train a race policy with PPO; returns a dict with ``metrics`` (one
    dict of floats per iteration: loss, mean_episode_return, mean_reward,
    steps), ``times`` (per iteration, the seconds of its phases:
    rollout, gae, update, and the whole iteration), ``env``, the final
    ``ts`` (``rl.ppo.TrainState``; ``ts.params`` is the policy), the PPO
    ``cfg`` and its ``train_step``. Runs on ``device``, the card unless
    the caller asks for the CPU; writes the policy to ``out`` when
    given. ``general`` trains on the general race env, ``fast`` (which
    implies it) with its window in the K3 kernel; ``env`` is then a
    ``GeneralEnv``."""
    general = general or fast
    if league:
        _not_ported("--league")
    if prox_penalty:
        _not_ported("--prox_penalty")
    if obs != "kin":
        _not_ported("--obs rgb")
    if general and n_drones > 1:
        raise ValueError("n_drones > 1 trains on the row env (self-play); "
                         "the general env takes one drone")
    if general and fuse_policy:
        raise ValueError("fuse_policy runs the policy inside the row env's "
                         "kernels; the general env runs it outside")
    device = torch.device(device)
    if device.type == "cuda":
        # the learner's matmuls in full float32 (PyTorch's default, stated)
        torch.backends.cuda.matmul.allow_tf32 = False
    hidden = tuple(int(h) for h in hidden)
    cfg_yaml = load_config(config)
    mode = RaceMode.COMPETE if compete else RaceMode.COMPARE
    spec = race_mod.RaceSpec.from_config(cfg_yaml, n_drones, mode,
                                         Physics.PYB)
    track = race_mod.track_from_config(cfg_yaml, n_drones)

    # self-play: the PPO batch is every drone of every env
    ppo_rows = n_envs * n_drones
    blk = max(1, shuffle_block)
    mb = ppo_rows * n_steps // 8
    while mb % blk:
        blk //= 2
    cfg = PPOConfig(n_envs=ppo_rows, n_steps=n_steps, shuffle_block=blk)
    if ent_coef is not None:
        cfg = dataclasses.replace(cfg, ent_coef=ent_coef)
    if lr is not None:
        cfg = dataclasses.replace(cfg, lr=lr)
    if lr_decay:
        cfg = dataclasses.replace(cfg,
                                  total_updates=cfg.updates_for_iters(iters))

    env_seed, ppo_seed = (int(s) for s in
                          np.random.SeedSequence(seed).generate_state(2))
    gen = torch.Generator(device=device)
    gen.manual_seed(env_seed)
    rollout_override = None
    if general:
        env = GeneralEnv(spec, track, n_envs, device, gen, end_after_gate,
                         fast)
        adapter = EnvAdapter(batched_reset=env.reset, step=env.step,
                             obs_dim=spec.obs_size, act_dim=4)
    else:
        env, adapter, rollout_override = _row_adapter(
            spec, track, n_envs, n_steps, device, gen, end_after_gate,
            elim_penalty, hidden, fuse_policy, kernel_chunk)
    C = spec.obs_size

    init_fn, train_step, _ = make_ppo_core(
        cfg, adapter, hidden=hidden, rollout_override=rollout_override,
        device=device)
    ts = init_fn(ppo_seed)
    if init:
        warm = ckpt.load_policy(init, device)
        if warm.hidden != hidden or warm.obs_dim != C:
            raise ValueError(f"{init}: widths {warm.obs_dim}-{warm.hidden} "
                             f"do not fit {C}-{hidden}")
        ts.params.load_state_dict(warm.state_dict())
        print("warm-started from", init, flush=True)

    hist, times = [], []
    t_start = time.perf_counter()
    for it in range(iters):
        t0 = time.perf_counter()
        phase = {}
        ts, metrics = train_step(ts, times=phase)
        m = {k: float(v) for k, v in metrics.items()}
        phase["iteration"] = time.perf_counter() - t0
        hist.append(m)
        times.append(phase)
        if log_every and (it % log_every == 0 or it == iters - 1):
            rate = (it + 1) * cfg.batch_size / (time.perf_counter() - t_start)
            print(f"[{it:4d}] mean_ep_return {m['mean_episode_return']:8.3f}"
                  f"  mean_reward {m['mean_reward']:7.4f}"
                  f"  loss {m['loss']:8.4f}  ({rate:,.0f} steps/s)",
                  flush=True)
        if out and save_every and (it + 1) % save_every == 0:
            stem, ext = str(out).rsplit(".", 1)
            ckpt.save_policy(f"{stem}_it{it + 1}.{ext}", ts.params)
    if out:
        ckpt.save_policy(out, ts.params)
        print("saved policy:", out, flush=True)
    return {"metrics": hist, "times": times, "env": env, "ts": ts,
            "cfg": cfg, "train_step": train_step}


def _row_adapter(spec, track, n_envs, n_steps, device, gen, end_after_gate,
                 elim_penalty, hidden, fuse_policy, kernel_chunk):
    """The row env, its PPO adapter and, with ``fuse_policy``, the policy
    rollout's override."""
    N = spec.num_drones
    env = make_row_env(spec, track, n_envs, device=device, generator=gen,
                       end_after_gate=end_after_gate,
                       per_drone_reward=N > 1,
                       elim_penalty=elim_penalty, policy_hidden=hidden)
    B, C = n_envs, spec.obs_size

    def batched_reset():
        st = env.reset()
        return st, env.initial_obs(st).reshape(B * N, C)

    def step_fn(env_state, action):
        act = action.reshape(B, N, 4) if N > 1 else action
        env_state, o, reward, done = env.step(env_state, act)[:4]
        if N == 1:
            return env_state, o, reward, done
        return (env_state, o.reshape(B * N, C), reward.reshape(B * N),
                done.repeat_interleave(N))

    adapter = EnvAdapter(batched_reset=batched_reset, step=step_fn,
                         obs_dim=C, act_dim=4)
    override = None
    if fuse_policy:
        b_reset, override, fused_step = make_policy_rollout(
            env, n_steps, kernel_chunk=kernel_chunk)
        adapter = adapter._replace(batched_reset=b_reset, step=fused_step)
    return env, adapter, override


class GeneralEnv:
    """The general race env of ``train``'s ``general`` path: B envs of one
    drone (envs/race_rl.py), drawing its resets and disturbances from
    ``generator``. ``fast`` runs the window in the K3 kernel, with its
    constants folded once here. ``reset()`` and ``step(state, action)``
    are the PPO adapter's (scripts/train_race.py:192-200, :340-351)."""

    def __init__(self, spec, track, n_envs, device, generator,
                 end_after_gate=0, fast=False):
        if fast and not race_fast.supports(spec):
            raise ValueError("fast: PYB physics, CF2X drones and a config "
                             "without disturbances only")
        self.spec, self.n_envs = spec, n_envs
        self.device = torch.device(device)
        self.track = race_mod.track_tensors(track, self.device)
        self.generator = generator
        self.end_after_gate = end_after_gate
        self.fast = fast
        self.consts = race_fast.window_consts_of(spec) if fast else None

    def reset(self):
        st = race_rl.rl_race_reset(self.spec, self.track, self.n_envs,
                                   generator=self.generator,
                                   device=self.device)
        obs = race_mod.compute_obs(self.spec, self.track, st.race)
        return st, obs.reshape(self.n_envs, -1)

    def step(self, state, action):
        state, obs, reward, term, trunc = race_rl.batched_rl_race_step(
            self.spec, self.track, state, action.reshape(self.n_envs, 1, 4),
            generator=self.generator, end_after_gate=self.end_after_gate,
            fast=self.fast, consts=self.consts)
        return state, obs.reshape(self.n_envs, -1), reward, term | trunc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="twogates",
                    help="a bundled config name or a YAML path")
    ap.add_argument("--n_envs", type=int, default=256)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--n_steps", type=int, default=64)
    ap.add_argument("--end_after_gate", type=int, default=2,
                    help="end an episode after N gates (0 = full track)")
    ap.add_argument("--out", default="race_policy.msgpack")
    ap.add_argument("--init", default=None,
                    help="warm-start from a policy .msgpack")
    ap.add_argument("--save_every", type=int, default=0,
                    help="also save the policy every N iterations")
    ap.add_argument("--shuffle_block", type=int, default=512,
                    help="minibatch shuffle granularity (1 = per sample)")
    ap.add_argument("--ent_coef", type=float, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--lr_decay", action="store_true",
                    help="linear LR decay to 0 over the run")
    ap.add_argument("--elim_penalty", type=float, default=1.0,
                    help="per-drone penalty at elimination (1.0 = "
                         "reference)")
    ap.add_argument("--kernel_chunk", type=int, default=16,
                    help="with --fuse_policy: env steps per race_rollout "
                         "launch (0 = one race_step launch per step)")
    ap.add_argument("--fuse_policy", action="store_true",
                    help="run the policy forward and sampling inside the "
                         "race kernels")
    ap.add_argument("--hidden", default="64,64",
                    help="ActorCritic tower widths, e.g. 256,128")
    ap.add_argument("--n_drones", type=int, default=1,
                    help=">1: shared-policy self-play, a reward per drone")
    ap.add_argument("--compete", action="store_true",
                    help="COMPETE mode: drone-drone collisions and "
                         "opponent poses in the observation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--general", action="store_true",
                    help="train on the general race env (commander, "
                         "firmware and collisions as tensor ops; one "
                         "drone) instead of the row env")
    ap.add_argument("--fast", action="store_true",
                    help="the general race env with each step's firmware "
                         "window in the window kernel (implies --general)")
    ap.add_argument("--league", default=None, help="not ported yet")
    ap.add_argument("--prox_penalty", type=float, default=0.0,
                    help="not ported yet")
    ap.add_argument("--obs", default="kin", choices=["kin", "rgb"],
                    help="'rgb' is not ported yet")
    args = ap.parse_args(argv)
    train(config=args.config, n_envs=args.n_envs, iters=args.iters,
          n_steps=args.n_steps, end_after_gate=args.end_after_gate,
          out=args.out, init=args.init, save_every=args.save_every,
          shuffle_block=args.shuffle_block, ent_coef=args.ent_coef,
          lr=args.lr, lr_decay=args.lr_decay,
          elim_penalty=args.elim_penalty, kernel_chunk=args.kernel_chunk,
          fuse_policy=args.fuse_policy,
          hidden=tuple(int(x) for x in args.hidden.split(",")),
          n_drones=args.n_drones, compete=args.compete, seed=args.seed,
          device=args.device, general=args.general, league=args.league,
          prox_penalty=args.prox_penalty, obs=args.obs, fast=args.fast)


if __name__ == "__main__":
    main()
