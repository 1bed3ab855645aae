"""PPO learner over batched envs, in PyTorch.

Counterpart of gym_pybullet_adrp_tpu/rl/ppo.py (``PPOConfig`` :34,
``EnvAdapter`` :82, ``Transition`` :98, ``TrainState`` :107, ``ppo_loss``
:117, ``grouped_update`` :135, ``make_ppo_core`` :162, ``hover_adapter``
:378, ``rgb_hover_adapter`` :413, ``make_ppo`` :444, ``flatten_obs``
:458). The JAX package
computes the learner in XLA, outside any Pallas kernel, so here it is
plain PyTorch with autograd: GAE as a reverse loop over time, then
``n_epochs`` x ``n_minibatches`` clipped-surrogate updates on block-
shuffled minibatches, with optax's ``clip_by_global_norm`` then
``adam(lr, eps=1e-5)`` written out (``ClipAdam``) so the update is
optax's to the rounding.

Random numbers: ``TrainState.rng`` is a ``torch.Generator`` on the
learner's device. It draws the policy's Gaussian noise in the rollout and
the minibatch permutations, in that order, each iteration; the env draws
from its own generator (``EnvAdapter.generator``), which the train state
carries as ``env_rng`` so that a checkpoint (rl/checkpoint.py) holds it.
JAX splits keys instead, so the two packages give different streams
from one seed.

The learner runs in float32. On the card that needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)
and, for the pixel policy's convolutions, ``torch.backends.cudnn.
allow_tf32 = False`` (on by default), which ``train_race.train`` sets.

Data parallelism (parallel/distributed.py): with a ``torch.distributed``
process ``group``, ``grouped_update`` averages the accumulated gradient
over the group before the optimizer (the JAX ``pmean`` over the mesh
axis, before the clip), in one all-reduce of one flat buffer per update
group, and ``train_step`` averages its metrics over the group.
"""

import copy
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..envs import rl as rlenv
from ..models.drone import DroneParams
from ..models.policy import (
    ActorCritic, gaussian_entropy, gaussian_logp, sample_action,
)


@dataclass(frozen=True)
class PPOConfig:
    """SB3-default PPO hyperparameters (see the JAX ``PPOConfig``)."""

    n_envs: int = 256
    n_steps: int = 64          # rollout horizon per env per iteration
    n_epochs: int = 10
    n_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    # linear LR decay to 0 over this many optimizer updates; None = constant
    total_updates: Optional[int] = None
    # minibatch shuffle granularity: 1 = per-sample permutation, >1 =
    # permute contiguous blocks of that many samples
    shuffle_block: int = 1
    # average the gradients of this many consecutive minibatches per
    # optimizer update (must divide n_minibatches)
    grad_accum: int = 1

    @property
    def batch_size(self):
        return self.n_envs * self.n_steps

    def updates_for_iters(self, n_iters: int) -> int:
        """Optimizer updates across ``n_iters`` iterations."""
        return n_iters * self.n_epochs * (
            self.n_minibatches // self.grad_accum)


class EnvAdapter(NamedTuple):
    """The batched env PPO trains against.

    batched_reset() -> (env_state, flat_obs (n_envs, obs_dim))
    step(env_state, action (n_envs, act_dim)) -> (env_state, flat_obs,
        reward (n_envs,), done (n_envs,)), autoreset: the post-done obs
        is the fresh episode's first obs.
    generator: the ``torch.Generator`` the env draws from, or None.
    """

    batched_reset: Callable
    step: Callable
    obs_dim: int
    act_dim: int
    generator: Optional[torch.Generator] = None


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


METRICS = ("loss", "mean_episode_return", "mean_reward", "steps")


class AdamState(NamedTuple):
    count: int
    mu: list
    nu: list


class TrainState(NamedTuple):
    params: ActorCritic          # updated in place by the optimizer
    opt_state: AdamState
    env_state: object
    last_obs: torch.Tensor       # (n_envs, obs_dim)
    rng: torch.Generator
    ep_return: torch.Tensor
    ep_len: torch.Tensor
    env_rng: Optional[torch.Generator] = None   # the env's draws


def linear_schedule(init_value, end_value, transition_steps):
    """optax.linear_schedule: ``init_value`` to ``end_value`` over
    ``transition_steps`` updates, then constant."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


class ClipAdam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr, eps))`` as
    optax computes it: the global norm over every gradient, a clipped
    gradient ``g / norm * max_norm`` where the norm reaches ``max_norm``
    (optax's formula; ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
    norm), Adam moments with bias correction and ``eps`` added to the root
    (1e-5 by default, not torch's 1e-8), the step ``-lr(count) *
    update``. With ``max_norm`` None it is ``adam(lr, eps)`` alone."""

    def __init__(self, lr, max_norm, eps=1e-5, b1=0.9, b2=0.999):
        self.lr = lr if callable(lr) else (lambda count: lr)
        self.max_norm, self.eps, self.b1, self.b2 = max_norm, eps, b1, b2

    def init(self, params):
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def global_norm(self, grads):
        """The l2 norm over every gradient (the tensor-parallel optimizer
        adds its shards' across ranks)."""
        return torch.sqrt(sum(torch.sum(g * g) for g in grads))

    def update(self, grads, state):
        """(updates, state') for ``grads``; no host synchronisation."""
        if self.max_norm is not None:
            norm = self.global_norm(grads)
            grads = [torch.where(norm < self.max_norm, g,
                                 (g / norm) * self.max_norm) for g in grads]
        b1, b2 = self.b1, self.b2
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        step = -self.lr(state.count)
        updates = [step * ((m / c1) / (torch.sqrt(v / c2) + self.eps))
                   for m, v in zip(mu, nu)]
        return updates, AdamState(count, mu, nu)


def ppo_loss(net, clip_eps, vf_coef, ent_coef, batch, advantages, returns):
    """Clipped-surrogate PPO loss with per-micro-batch advantage
    normalisation by the population std. Returns (total, (pg, v, ent))."""
    mean, log_std, value = net(batch.obs)
    logp = gaussian_logp(batch.action, mean, log_std)
    ratio = torch.exp(logp - batch.logp)
    adv = ((advantages - advantages.mean())
           / (advantages.std(correction=0) + 1e-8))
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    pg_loss = -torch.mean(torch.minimum(pg1, pg2))
    v_loss = 0.5 * torch.mean((value - returns) ** 2)
    ent = gaussian_entropy(log_std)
    total = pg_loss + vf_coef * v_loss - ent_coef * ent
    return total, (pg_loss, v_loss, ent)


def group_mean(tensors, group):
    """The mean over the ranks of ``group`` of each of ``tensors`` (one
    dtype), by one SUM all-reduce of their concatenation divided by the
    group's size (gloo has no AVG; JAX's ``pmean`` is ``psum / n``)."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat / dist.get_world_size(group)
    return [x.view_as(t) for x, t in
            zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def grouped_update(loss_fn, tx, g, net, opt_state, xs, group=None):
    """``g`` gradient-accumulation micro-steps and ONE optimizer update:
    ``xs`` holds g (batch, advantages, returns) micro-batches; the applied
    gradient is the mean of their gradients, and, with a process
    ``group``, that mean averaged over the group's ranks (one all-reduce).
    Updates ``net`` in place; returns (opt_state', [loss per
    micro-batch])."""
    params = list(net.parameters())
    acc = [torch.zeros_like(p) for p in params]
    losses = []
    for batch, adv, ret in xs:
        loss, _ = loss_fn(net, batch, adv, ret)
        grads = torch.autograd.grad(loss, params)
        acc = [a + gr for a, gr in zip(acc, grads)]
        losses.append(loss.detach())
    grads = [a / g for a in acc]
    if group is not None:
        grads = group_mean(grads, group)
    updates, opt_state = tx.update(grads, opt_state)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)
    return opt_state, losses


def compute_gae(cfg: PPOConfig, traj: Transition, last_value):
    """(advantages, returns) by GAE(gamma, lambda), a reverse loop over
    the (n_steps, batch) trajectory."""
    adv = torch.empty_like(traj.value)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(traj.value.shape[0])):
        nonterminal = 1.0 - traj.done[t].to(last_value.dtype)
        delta = (traj.reward[t] + cfg.gamma * next_value * nonterminal
                 - traj.value[t])
        gae = delta + cfg.gamma * cfg.gae_lambda * nonterminal * gae
        adv[t] = gae
        next_value = traj.value[t]
    return adv, adv + traj.value


def minibatch_epoch(cfg: PPOConfig, tx, net, opt_state, traj, advantages,
                    returns, take, group=None):
    """One epoch: ``cfg.n_minibatches`` minibatches cut from the batch
    permuted by blocks of ``cfg.shuffle_block`` samples in the order of
    ``take`` (a permutation of the blocks), ``cfg.grad_accum`` of them per
    optimizer update (averaged over the ranks of a process ``group``).
    Updates ``net`` in place; returns (opt_state', [loss per
    minibatch])."""
    batch_size, n_mb = cfg.batch_size, cfg.n_minibatches
    mb, blk, g = batch_size // n_mb, cfg.shuffle_block, cfg.grad_accum
    if batch_size % blk or mb % blk:
        raise ValueError("shuffle_block must divide the minibatch size")
    if n_mb % g:
        raise ValueError("grad_accum must divide n_minibatches")
    n_blocks = batch_size // blk
    take = take[:(mb * n_mb) // blk]

    def shuffle(x):
        return x.reshape((n_blocks, blk) + x.shape[2:])[take].reshape(
            (n_mb, mb) + x.shape[2:])

    def loss_fn(net_, batch, adv_, ret_):
        return ppo_loss(net_, cfg.clip_eps, cfg.vf_coef, cfg.ent_coef,
                        batch, adv_, ret_)

    obs, act, logp = (shuffle(traj.obs), shuffle(traj.action),
                      shuffle(traj.logp))
    adv, ret = shuffle(advantages), shuffle(returns)
    losses = []
    for i0 in range(0, n_mb, g):
        xs = [(Transition(obs[i], act[i], logp[i], None, None, None),
               adv[i], ret[i]) for i in range(i0, i0 + g)]
        opt_state, ls = grouped_update(loss_fn, tx, g, net, opt_state, xs,
                                       group)
        losses += ls
    return opt_state, losses


@torch.no_grad()
def policy_rollout(n_steps, env_step, ts: TrainState, sample):
    """``n_steps`` steps of the policy ``ts.params`` on the env of
    ``env_step`` (an ``EnvAdapter.step``), each action drawn by
    ``sample(mean, log_std) -> (action, logp)`` and clipped to [-1, 1]
    for the env. Returns (ts', trajectory, {"finished_return",
    "finished_len"}), the episodes ended in each step."""
    trs, fin_ret, fin_len = [], [], []
    for _ in range(n_steps):
        mean, log_std, value = ts.params(ts.last_obs)
        action, logp = sample(mean, log_std)
        env_state, obs, reward, done = env_step(
            ts.env_state, torch.clamp(action, -1.0, 1.0))
        ep_return = ts.ep_return + reward
        ep_len = ts.ep_len + 1
        trs.append(Transition(ts.last_obs, action, logp, value,
                              reward.to(torch.float32), done))
        fin_ret.append(torch.where(done, ep_return, float("nan")))
        fin_len.append(torch.where(done, ep_len, -1))
        ts = ts._replace(
            env_state=env_state, last_obs=obs.to(torch.float32),
            ep_return=torch.where(done, 0.0, ep_return),
            ep_len=torch.where(done, 0, ep_len))
    traj = Transition(*[torch.stack(x) for x in zip(*trs)])
    return ts, traj, {"finished_return": torch.stack(fin_ret),
                      "finished_len": torch.stack(fin_len)}


def make_ppo_core(cfg: PPOConfig, adapter: EnvAdapter, hidden=(64, 64),
                  rollout_override=None, device="cuda", network=None,
                  group=None):
    """Build ``(init_fn, train_step, eval_rollout)`` for any EnvAdapter.

    ``init_fn(seed) -> TrainState``: the policy is an ``ActorCritic`` of
    ``hidden`` widths, or, when ``network`` (a module with the same
    ``(mean, log_std, value)`` contract and a ``reset_parameters(
    generator)``, e.g. ``CnnActorCritic`` for pixel observations) is
    given, a copy of it with weights drawn from the seed, as the JAX
    package's ``network.init`` draws them from its key.
    ``train_step(ts, times=None) -> (ts, metrics)`` runs one PPO iteration; with a ``times`` dict it also
    records the seconds of its phases ("rollout", "gae", "update"),
    synchronising the device at each boundary. ``eval_rollout(net,
    n_steps) -> (n_envs,)`` is each env's deterministic (mean-action)
    return over its first episode within ``n_steps`` steps from a fresh
    reset (SB3 ``evaluate_policy(deterministic=True)``).

    ``rollout_override(ts) -> (ts, traj, metrics)`` replaces the default
    rollout (policy forward, sample, ``adapter.step`` per step), as the
    policy-in-kernel race rollout does
    (envs/race_rl_rowfast.make_policy_rollout).

    ``group``, a ``torch.distributed`` process group, makes each rank's
    step one shard of a data-parallel step: the gradients are averaged
    over it before every optimizer update, and the metrics (as float32
    tensors) after the iteration.
    """
    device = torch.device(device)
    lr = (linear_schedule(cfg.lr, 0.0, cfg.total_updates)
          if cfg.total_updates is not None else cfg.lr)
    tx = ClipAdam(lr, cfg.max_grad_norm)

    def init_fn(seed=0):
        gen = torch.Generator().manual_seed(seed)
        if network is None:
            net = ActorCritic(adapter.obs_dim, adapter.act_dim, hidden,
                              generator=gen)
        else:
            net = copy.deepcopy(network)
            net.reset_parameters(gen)
        net = net.to(device)
        rng = torch.Generator(device=device)
        rng.manual_seed(seed)
        env_state, obs = adapter.batched_reset()
        return TrainState(
            params=net, opt_state=tx.init(list(net.parameters())),
            env_state=env_state, last_obs=obs.to(torch.float32), rng=rng,
            ep_return=torch.zeros(cfg.n_envs, device=device),
            ep_len=torch.zeros(cfg.n_envs, dtype=torch.int32,
                               device=device),
            env_rng=adapter.generator,
        )

    def rollout(ts):
        return policy_rollout(cfg.n_steps, adapter.step, ts,
                              lambda mean, log_std: sample_action(
                                  mean, log_std, ts.rng))

    def update_epoch(ts, opt_state, traj, advantages, returns):
        # permute the whole batch once (by blocks), then take contiguous
        # minibatches
        n_blocks = cfg.batch_size // cfg.shuffle_block
        take = torch.randperm(n_blocks, generator=ts.rng, device=device)
        return minibatch_epoch(cfg, tx, ts.params, opt_state, traj,
                               advantages, returns, take, group)

    def mark(times, name, t0):
        if times is None:
            return t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        if name is not None:
            times[name] = t1 - t0
        return t1

    def train_step(ts: TrainState, times=None):
        """One PPO iteration. Returns (train_state, metrics)."""
        t0 = mark(times, None, 0.0)
        if rollout_override is not None:
            ts, traj, roll_metrics = rollout_override(ts)
        else:
            ts, traj, roll_metrics = rollout(ts)
        t0 = mark(times, "rollout", t0)
        with torch.no_grad():
            _, _, last_value = ts.params(ts.last_obs)
            advantages, returns = compute_gae(cfg, traj, last_value)
        t0 = mark(times, "gae", t0)
        opt_state, losses = ts.opt_state, []
        for _ in range(cfg.n_epochs):
            opt_state, ls = update_epoch(ts, opt_state, traj, advantages,
                                         returns)
            losses += ls
        ts = ts._replace(opt_state=opt_state)
        mark(times, "update", t0)
        metrics = {
            "loss": torch.stack(losses).mean(),
            "mean_episode_return": torch.nanmean(
                roll_metrics["finished_return"]),
            "mean_reward": traj.reward.mean(),
            "steps": cfg.batch_size,
        }
        if group is not None:
            # the JAX package's pmean of each metric as float32
            # (parallel/distributed.py:156-158)
            vals = group_mean([torch.stack([
                metrics[k].to(torch.float32) for k in METRICS[:3]]
                + [torch.tensor(float(cfg.batch_size), device=device)])],
                group)[0]
            metrics = dict(zip(METRICS, vals.unbind()))
        return ts, metrics

    @torch.no_grad()
    def eval_rollout(net, n_steps: int):
        env_state, obs = adapter.batched_reset()
        obs = obs.to(torch.float32)
        ret = torch.zeros(obs.shape[0], device=obs.device)
        done_seen = torch.zeros(obs.shape[0], dtype=torch.bool,
                                device=obs.device)
        for _ in range(n_steps):
            mean, _, _ = net(obs)
            env_state, obs, reward, done = adapter.step(
                env_state, torch.clamp(mean, -1.0, 1.0))
            obs = obs.to(torch.float32)
            ret = ret + torch.where(done_seen, 0.0, reward)
            done_seen = done_seen | done
        return ret

    return init_fn, train_step, eval_rollout


# ---------------------------------------------------------------------------
# hover/multihover adapter (the reference learn.py tasks)


def hover_adapter(cfg: PPOConfig, rl_cfg: rlenv.RLConfig,
                  params: DroneParams, init_xyzs, init_rpys,
                  device="cuda") -> EnvAdapter:
    """EnvAdapter over ``cfg.n_envs`` envs of ``envs.rl`` (obs: each
    drone's KIN obs with its action history, flattened over drones)."""
    n_drones = rl_cfg.aviary.num_drones
    reset_template = rlenv.rl_reset(rl_cfg, init_xyzs, init_rpys, 1,
                                    device=device)

    def batched_reset():
        env_state = rlenv.rl_reset(rl_cfg, init_xyzs, init_rpys, cfg.n_envs,
                                   device=device)
        obs = rlenv.compute_obs(rl_cfg, env_state)
        return env_state, obs.reshape(cfg.n_envs, -1)

    def step(env_state, action):
        act = action.reshape(-1, n_drones, rl_cfg.act_size)
        env_state, obs, reward, term, trunc = rlenv.autoreset_step(
            rl_cfg, params, reset_template, env_state, act)
        return env_state, obs.reshape(obs.shape[0], -1), reward, term | trunc

    return EnvAdapter(batched_reset=batched_reset, step=step,
                      obs_dim=n_drones * rl_cfg.obs_size,
                      act_dim=n_drones * rl_cfg.act_size)


def rgb_hover_adapter(cfg: PPOConfig, rl_cfg: rlenv.RLConfig,
                      params: DroneParams, init_xyzs, init_rpys,
                      width: int = 32, height: int = 24,
                      device="cuda") -> EnvAdapter:
    """Pixels-to-actions hover: ``hover_adapter``'s env with drone 0's POV
    frame (``rl.compute_rgb_obs``, every env in one render) as the
    observation; after a done the frame is the reset state's. Pair with
    ``CnnActorCritic(act_dim, img_h=height, img_w=width)``."""
    kin = hover_adapter(cfg, rl_cfg, params, init_xyzs, init_rpys,
                        device=device)

    def frames(env_state):
        return rlenv.compute_rgb_obs(rl_cfg, params, env_state, width,
                                     height)

    def batched_reset():
        env_state, _ = kin.batched_reset()
        return env_state, frames(env_state)

    def step(env_state, action):
        env_state, _, reward, done = kin.step(env_state, action)
        return env_state, frames(env_state), reward, done

    return EnvAdapter(batched_reset=batched_reset, step=step,
                      obs_dim=height * width * 3, act_dim=kin.act_dim)


def make_ppo(cfg: PPOConfig, rl_cfg: rlenv.RLConfig, params: DroneParams,
             init_xyzs, init_rpys, hidden=(64, 64), device="cuda",
             group=None, rollout_override=None):
    """Hover-task PPO (the learner of examples/learn.py): ``(init_fn,
    train_step, eval_rollout)`` as ``make_ppo_core``'s (``group`` and
    ``rollout_override`` as there), with ``eval_rollout`` returning the
    first env's return only."""
    adapter = hover_adapter(cfg, rl_cfg, params, init_xyzs, init_rpys,
                            device=device)
    init_fn, train_step, eval_core = make_ppo_core(
        cfg, adapter, hidden=hidden, device=device, group=group,
        rollout_override=rollout_override)

    def eval_rollout(net, n_steps: int):
        return eval_core(net, n_steps)[:1]

    return init_fn, train_step, eval_rollout


def flatten_obs(cfg: rlenv.RLConfig, obs):
    """(..., N, D) per-drone obs -> flat (..., N*D) vector."""
    return obs.reshape(obs.shape[:-2] + (-1,))
