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

On the row env with N > 1 COMPETE drones, two options of the JAX
script shape the self-play (:61-66, :95-110, :222-330, :400-410):

* ``--prox_penalty w`` (``prox_shape``): each drone's reward loses
  ``w * max(0, 1 - d / --prox_radius)``, d its nearest opponent's
  horizontal distance read from the opponent-pose obs channels.
* ``--league a.msgpack,b.msgpack,...``: drone 0 of every env is the
  learner; drones 1..N-1 fly the mean action of a frozen pool member
  (env block i of n_envs/P takes member i, ``OpponentPool``), and the
  PPO batch holds drone 0's rows only. ``--league_refresh k`` copies the
  learner into pool slot 0 every k iterations.

Both compute outside the kernel, between its launches (one race_step
launch a step), so they do not combine with ``--fuse_policy``.

``--obs rgb`` (camera-based racing, the JAX script's :362-386) trains
on the general env (eager, one drone): each step renders drone 0's POV
frame of every env from the post-step (post-autoreset) state
(envs/race_rl.compute_rgb_obs, ``--img WxH``, ``--fov``, ``--camera
body|velocity``), and the policy is a ``CnnActorCritic``. The
convolutions run in full float32 on the card (cuDNN's TF32 off). It
launches none of the port's kernels. The JAX script's guards raise
``ValueError`` here, these among them.

Usage:
  python -m gym_pybullet_adrp_tpu_torch.train_race \\
      --config getting_started --n_envs 4096 --fuse_policy
  python -m gym_pybullet_adrp_tpu_torch.train_race --fast --n_envs 4096
  python -m gym_pybullet_adrp_tpu_torch.train_race --config level3 \\
      --compete --n_drones 4 --n_envs 1024 --end_after_gate 0 \\
      --league results/level3_mastery.msgpack,results/level3_selfplay.msgpack
  python -m gym_pybullet_adrp_tpu_torch.train_race \\
      --config getting_started --obs rgb --img 64x48 --fov 110 \\
      --camera velocity --n_envs 512 --n_steps 64 --lr_decay \\
      --init results/px5/g3.msgpack --end_after_gate 0
"""

import argparse
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .envs import race as race_mod
from .envs import race_fast, race_rl
from .envs.race_rl_rowfast import (
    RowRaceState, make_policy_rollout, make_row_env,
)
from .models.policy import CnnActorCritic
from .rl import checkpoint as ckpt
from .rl.ppo import EnvAdapter, PPOConfig, make_ppo_core
from .utils.config import load_config
from .utils.enums import Physics, RaceMode


def train(config="twogates", n_envs=256, iters=200, n_steps=64,
          end_after_gate=2, out=None, init=None, save_every=0,
          shuffle_block=512, ent_coef=None, lr=None, lr_decay=False,
          elim_penalty=1.0, kernel_chunk=16, fuse_policy=False,
          hidden=(64, 64), n_drones=1, compete=False, seed=0,
          device="cuda", log_every=10, general=False, league=None,
          league_refresh=0, prox_penalty=0.0, prox_radius=0.3, obs="kin",
          fast=False, img="32x24", fov=60.0, camera="body"):
    """Train a race policy with PPO; returns a dict with ``metrics`` (one
    dict of floats per iteration: loss, mean_episode_return, mean_reward,
    steps), ``times`` (per iteration, the seconds of its phases:
    rollout, gae, update, and the whole iteration), ``env``, the final
    ``ts`` (``rl.ppo.TrainState``; ``ts.params`` is the policy), the PPO
    ``cfg`` and its ``train_step``. Runs on ``device``, the card unless
    the caller asks for the CPU; writes the policy to ``out`` when
    given. ``general`` trains on the general race env, ``fast`` (which
    implies it) with its window in the K3 kernel; ``env`` is then a
    ``GeneralEnv``. ``league`` (comma-separated policy paths, or a list)
    trains drone 0 against a frozen pool (``ts.env_state`` is then a
    ``LeagueState``), refreshed every ``league_refresh`` iterations;
    ``prox_penalty`` shapes COMPETE self-play rewards (``prox_shape``).
    ``obs="rgb"`` trains a ``CnnActorCritic`` on drone-POV frames of
    ``img`` ("WxH") at vertical field of view ``fov`` from ``camera``
    ("body" or "velocity") on the general env."""
    if isinstance(league, str):
        league = [p for p in league.split(",") if p]
    if obs not in ("kin", "rgb"):
        raise ValueError(f"obs must be 'kin' or 'rgb': {obs!r}")
    rgb = obs == "rgb"
    # the JAX script's guards (scripts/train_race.py:151-165)
    if rgb and (fast or fuse_policy):
        raise ValueError("obs rgb runs on the general env's eager step (no "
                         "fast, no fuse_policy)")
    if rgb and n_drones > 1:
        raise ValueError("obs rgb trains one drone on the general env; "
                         "n_drones > 1 is the row env's self-play")
    general = general or fast or rgb
    if general and n_drones > 1:
        raise ValueError("n_drones > 1 trains on the row env (self-play); "
                         "the general env takes one drone")
    if general and fuse_policy:
        raise ValueError("fuse_policy runs the policy inside the row env's "
                         "kernels; the general env runs it outside")
    if prox_penalty and not (n_drones > 1 and compete):
        raise ValueError("prox_penalty needs COMPETE self-play (compete, "
                         "n_drones > 1): it reads the opponent-pose "
                         "channels")
    if prox_penalty and fuse_policy:
        raise ValueError("prox_penalty shapes rewards between the kernel's "
                         "launches; use it without fuse_policy")
    if league and (general or not compete or n_drones < 2):
        raise ValueError("league needs the row env, compete and "
                         "n_drones > 1")
    if league and fuse_policy:
        raise ValueError("league computes the opponents' actions between "
                         "the kernel's launches; use it without fuse_policy")
    device = torch.device(device)
    if device.type == "cuda":
        # the learner's matmuls (PyTorch's default, stated) and the pixel
        # policy's convolutions (cuDNN's default is TF32) in full float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    hidden = tuple(int(h) for h in hidden)
    cfg_yaml = load_config(config)
    mode = RaceMode.COMPETE if compete else RaceMode.COMPARE
    spec = race_mod.RaceSpec.from_config(cfg_yaml, n_drones, mode,
                                         Physics.PYB)
    track = race_mod.track_from_config(cfg_yaml, n_drones)

    # self-play: the PPO batch is every drone of every env; league: only
    # the learner drone's rows
    ppo_rows = n_envs * (1 if league else n_drones)
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
                             obs_dim=spec.obs_size, act_dim=4,
                             generator=gen)
    else:
        env, adapter, rollout_override = _row_adapter(
            spec, track, n_envs, n_steps, device, gen, end_after_gate,
            elim_penalty, hidden, fuse_policy, kernel_chunk,
            prox_penalty, prox_radius, league)
    C = spec.obs_size
    network = None
    if rgb:
        W, H = (int(x) for x in img.split("x"))
        adapter = rgb_adapter(adapter, spec, W, H, fov, camera)
        network = CnnActorCritic(4, img_h=H, img_w=W)

    init_fn, train_step, _ = make_ppo_core(
        cfg, adapter, hidden=hidden, rollout_override=rollout_override,
        device=device, network=network)
    ts = init_fn(ppo_seed)
    if init:
        warm = ckpt.load_policy(init, device, img=(H, W) if rgb else None)
        if rgb:
            if warm.features != network.features:
                raise ValueError(f"{init}: {warm.features} features, not "
                                 f"{network.features}")
        elif warm.hidden != hidden or warm.obs_dim != C:
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
        if league and league_refresh and (it + 1) % league_refresh == 0:
            # past-selves league: slot 0 becomes the current learner
            ts = ts._replace(env_state=ts.env_state._replace(
                pool=refresh_pool(ts.env_state.pool, ts.params)))
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


def prox_shape(obs, reward, weight, radius):
    """``reward`` (B, N) less ``weight * clip(1 - d / radius, 0, 1)``,
    d each drone's horizontal distance to its nearest opponent, read from
    the COMPETE obs (B, N, C), whose last 6 (N - 1) channels are the
    opponents' poses (scripts/train_race.py:222-240)."""
    N, C = obs.shape[-2], obs.shape[-1]
    base = C - 6 * (N - 1)
    px, py = obs[..., 0], obs[..., 1]
    d2min = None
    for j in range(N - 1):
        d2 = ((px - obs[..., base + 6 * j]) ** 2
              + (py - obs[..., base + 6 * j + 1]) ** 2)
        d2min = d2 if d2min is None else torch.minimum(d2min, d2)
    pen = weight * torch.clamp(1.0 - torch.sqrt(d2min) / radius, 0.0, 1.0)
    return reward - pen


class OpponentPool(NamedTuple):
    """P frozen policies' actor towers, stacked: ``weight[i]`` (P, in,
    out) and ``bias[i]`` (P, 1, out) of hidden layer i, then the mean
    head's."""

    weight: tuple
    bias: tuple


def _actor_layers(net):
    return list(net.pi) + [net.pi_out]


def pool_from_policies(nets) -> OpponentPool:
    """The pool of the ``ActorCritic``s ``nets`` (one width)."""
    with torch.no_grad():
        layers = [_actor_layers(n) for n in nets]
        return OpponentPool(
            weight=tuple(torch.stack([ls[i].weight.T for ls in layers])
                         .contiguous() for i in range(len(layers[0]))),
            bias=tuple(torch.stack([ls[i].bias[None] for ls in layers])
                       for i in range(len(layers[0]))))


def pool_forward(pool: OpponentPool, obs):
    """The mean actions (P, M, act) of member p on ``obs[p]`` (P, M,
    obs_dim): tanh hidden layers then the linear head, as one batched
    matmul per layer (the JAX script's ``vmap(opp_net.apply)``)."""
    x = obs
    last = len(pool.weight) - 1
    for i, (w, b) in enumerate(zip(pool.weight, pool.bias)):
        x = torch.baddbmm(b, x, w)
        if i < last:
            x = torch.tanh(x)
    return x


def refresh_pool(pool: OpponentPool, net) -> OpponentPool:
    """``pool`` with slot 0 replaced by ``net``'s current weights."""
    with torch.no_grad():
        new = [(w.clone(), b.clone()) for w, b in zip(pool.weight,
                                                       pool.bias)]
        for (w, b), lay in zip(new, _actor_layers(net)):
            w[0] = lay.weight.T
            b[0, 0] = lay.bias
    return OpponentPool(tuple(w for w, _ in new), tuple(b for _, b in new))


class LeagueState(NamedTuple):
    """The league adapter's env state: the row env's state, the post-step
    obs of every drone (B, N, C) and the opponent pool."""

    row: RowRaceState
    obs: torch.Tensor
    pool: OpponentPool


def load_pool(paths, hidden, obs_dim, device="cuda") -> OpponentPool:
    """The pool of the policy artifacts at ``paths`` on ``device`` (the
    card unless the caller asks for the CPU), each of ``obs_dim``-``hidden``
    widths."""
    nets = [ckpt.load_policy(p, device) for p in paths]
    for p, n in zip(paths, nets):
        if n.hidden != hidden or n.obs_dim != obs_dim:
            raise ValueError(f"{p}: widths {n.obs_dim}-{n.hidden} do not "
                             f"fit {obs_dim}-{hidden}")
    return pool_from_policies(nets)


def _row_adapter(spec, track, n_envs, n_steps, device, gen, end_after_gate,
                 elim_penalty, hidden, fuse_policy, kernel_chunk,
                 prox_penalty=0.0, prox_radius=0.3, league=None):
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
        if prox_penalty:
            reward = prox_shape(o, reward, prox_penalty, prox_radius)
        return (env_state, o.reshape(B * N, C), reward.reshape(B * N),
                done.repeat_interleave(N))

    adapter = EnvAdapter(batched_reset=batched_reset, step=step_fn,
                         obs_dim=C, act_dim=4, generator=gen)
    override = None
    if league:
        pool0 = load_pool(league, hidden, C, device)
        P = pool0.weight[0].shape[0]
        if B % P:
            raise ValueError(f"n_envs ({B}) must divide by the league "
                             f"pool's size ({P})")
        print(f"league pool ({P}): {list(league)}", flush=True)

        def league_reset():
            st = env.reset()
            obs = env.initial_obs(st).reshape(B, N, C)
            return LeagueState(st, obs, pool0), obs[:, 0].contiguous()

        def league_step(env_state, action):
            # env block i (of B/P) plays against pool member i
            opp_obs = env_state.obs[:, 1:].reshape(P, (B // P) * (N - 1), C)
            opp_act = torch.clamp(pool_forward(env_state.pool, opp_obs),
                                  -1.0, 1.0).reshape(B, N - 1, 4)
            act = torch.cat([action.reshape(B, 1, 4), opp_act], dim=1)
            row, obs, reward, done = env.step(env_state.row, act)[:4]
            if prox_penalty:
                reward = prox_shape(obs, reward, prox_penalty, prox_radius)
            return (LeagueState(row, obs, env_state.pool),
                    obs[:, 0].contiguous(), reward[:, 0].contiguous(), done)

        adapter = adapter._replace(batched_reset=league_reset,
                                   step=league_step)
    if fuse_policy:
        b_reset, override, fused_step = make_policy_rollout(
            env, n_steps, kernel_chunk=kernel_chunk)
        adapter = adapter._replace(batched_reset=b_reset, step=fused_step)
    return env, adapter, override


def rgb_adapter(adapter: EnvAdapter, spec, width, height, fov,
                camera) -> EnvAdapter:
    """``adapter`` (the general env's) with drone 0's POV frame of every
    env, rendered from the post-step (post-autoreset) state, as the
    observation (scripts/train_race.py:362-386)."""
    def frames(env_state):
        return race_rl.compute_rgb_obs(spec, env_state, width, height, fov,
                                       camera)

    def reset():
        env_state, _ = adapter.batched_reset()
        return env_state, frames(env_state)

    def step(env_state, action):
        env_state, _, reward, done = adapter.step(env_state, action)
        return env_state, frames(env_state), reward, done

    return adapter._replace(batched_reset=reset, step=step,
                            obs_dim=height * width * 3)


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
    ap.add_argument("--league", default=None,
                    help="comma-separated frozen policy .msgpack paths: "
                         "drone 0 learns against drones 1..N-1 flying the "
                         "pool's mean actions (env block i of n_envs/P "
                         "takes member i); needs --compete --n_drones > 1")
    ap.add_argument("--league_refresh", type=int, default=0,
                    help="with --league: copy the learner into pool slot "
                         "0 every N iterations (0 = frozen pool)")
    ap.add_argument("--prox_penalty", type=float, default=0.0,
                    help="COMPETE self-play: reward -= w * max(0, 1 - "
                         "d/radius), d the nearest opponent's horizontal "
                         "distance")
    ap.add_argument("--prox_radius", type=float, default=0.3,
                    help="the proximity shaping's radius (m)")
    ap.add_argument("--obs", default="kin", choices=["kin", "rgb"],
                    help="'rgb': camera-based racing, drone-POV frames "
                         "ray-cast each step and a conv actor-critic "
                         "(the general env, one drone)")
    ap.add_argument("--img", default="32x24",
                    help="with --obs rgb: frame WxH (the reference "
                         "camera's: 64x48)")
    ap.add_argument("--fov", type=float, default=60.0,
                    help="with --obs rgb: vertical field of view, degrees")
    ap.add_argument("--camera", default="body", choices=["body", "velocity"],
                    help="with --obs rgb: 'body' looks along body +x (the "
                         "reference rig), 'velocity' along the horizontal "
                         "velocity")
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
          league_refresh=args.league_refresh,
          prox_penalty=args.prox_penalty, prox_radius=args.prox_radius,
          obs=args.obs, fast=args.fast, img=args.img, fov=args.fov,
          camera=args.camera)


if __name__ == "__main__":
    main()
