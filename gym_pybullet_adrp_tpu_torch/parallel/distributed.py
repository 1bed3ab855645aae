"""Data- and tensor-parallel PPO and the sharded rollouts on
``torch.distributed``.

Counterpart of gym_pybullet_adrp_tpu/parallel/distributed.py
(``make_mesh`` :42, ``make_mesh_2d`` :55, ``state_specs`` :70,
``host_to_global`` :89, ``make_distributed_ppo`` :113,
``actor_critic_tp_specs`` :194, ``make_pjit_ppo`` :225,
``rollout_throughput_fn`` :277, ``race_rollout_throughput_fn`` :323). A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over ranks, each
rank one process (parallel/hosts.py joins the group); its dims are named
"dp" (the env batch) and "tp" (the learner's hidden features).

* ``make_distributed_ppo``: every rank steps ``cfg.n_envs`` envs of its
  own and holds the whole learner; ``rl/ppo.py`` averages the gradient
  over "dp" before each optimizer update (one all-reduce per update
  group) and the metrics after the iteration: the JAX ``shard_map`` step
  with its ``pmean``s. Each rank normalises its advantages over its own
  shard.
* ``make_pjit_ppo``: the single-process step's semantics on a
  ("dp", "tp") mesh, written out where JAX leaves it to XLA's SPMD
  partitioner. ``cfg.n_envs`` is global. The ActorCritic's hidden layers
  are split Megatron-style over "tp" (``copy_to_tp`` before a
  column-parallel layer, ``reduce_from_tp`` after a row-parallel one);
  the ranks draw the rollout noise and the minibatch permutations for the
  global batch from one replicated generator and take their slice, the
  trajectory is gathered over "dp", each dp rank takes its contiguous
  share of each minibatch, the advantages are normalised by the whole
  minibatch's mean and std (each rank holds the gathered trajectory), the
  loss is a global mean and the gradients are summed over "dp"; the
  global-norm clip adds the shards' squares over "tp".
* ``rollout_throughput_fn`` / ``race_rollout_throughput_fn``: env
  stepping on every rank, one all-reduce of the reward sum at the end.
  The race rollout launches the race_step kernel per step, or the
  race_rollout kernel every ``rollout_k`` steps, on CUDA tensors (their
  plain versions on CPU tensors).

All collectives here are all-reduce and broadcast, the two that gloo also
runs on CUDA tensors (ranks sharing one card); gathers of CUDA tensors on
gloo go through the host.
"""

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..envs import rl as rlenv
from ..models.policy import ActorCritic, gaussian_entropy, gaussian_logp
from ..rl import ppo
from . import hosts

AXIS = hosts.AXIS
TP_AXIS = "tp"
REPLICATED = "replicated"


# ---------------------------------------------------------------------------
# meshes and state layout


def _mesh(shape, names):
    if not dist.is_initialized():
        raise RuntimeError("no process group: join one first "
                           "(parallel.hosts.ensure_initialized)")
    need, world = math.prod(shape), dist.get_world_size()
    if world < need:
        raise ValueError(f"need {need} ranks, have {world}")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    dtype = hosts.mesh_device_type()
    if need == world:
        return init_device_mesh(dtype, shape, mesh_dim_names=names)
    return DeviceMesh(dtype, torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(n=None):
    """A 1-D "dp" mesh over the first ``n`` ranks (all when None)."""
    return _mesh((dist.get_world_size() if n is None else n,), (AXIS,))


def make_mesh_2d(n_dp: int, n_tp: int):
    """("dp", "tp") mesh: env batch over dp, learner hidden dims over
    tp; rank r sits at (r // n_tp, r % n_tp)."""
    return _mesh((n_dp, n_tp), (AXIS, TP_AXIS))


def axis(mesh, name):
    """(group, this rank's index on ``name``, the dim's size)."""
    group = mesh.get_group(name)
    return group, dist.get_rank(group), dist.get_world_size(group)


def state_specs(ts: ppo.TrainState) -> ppo.TrainState:
    """How each field of a ``TrainState`` lies over the mesh: "dp" for
    the fields sharded on their leading env axis (every leaf of the env
    state, the observations and episode counters) and for the per-rank
    generators, ``REPLICATED`` for the learner (params, Adam state)."""
    return ppo.TrainState(
        params=REPLICATED, opt_state=REPLICATED, env_state=AXIS,
        last_obs=AXIS, rng=AXIS, ep_return=AXIS, ep_len=AXIS,
        env_rng=AXIS)


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if t is None:
        return None
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*[_tree_map(fn, *xs) for xs in zip(*trees)])
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"not a tensor tree: {type(t)}")


def rank_seeds(seed: int, n: int):
    """``n`` independent seeds from ``seed``, one per rank: the JAX
    package's ``random.split`` of the key per device."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(n)]


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_into(flat, tensors):
    i = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


def host_to_global(mesh, ts: ppo.TrainState) -> ppo.TrainState:
    """This rank's shard of a host-built full ``TrainState`` (every rank
    must hold the same one, as ``make_distributed_ppo``'s ``global_init``
    builds it): its slice of each "dp" field, its own generators, and the
    learner broadcast from the mesh's first rank (one broadcast)."""
    group, r, n = axis(mesh, AXIS)
    per = ts.last_obs.shape[0] // n

    def shard(x):
        return x[r * per:(r + 1) * per].clone()

    learner = list(ts.params.parameters()) + ts.opt_state.mu \
        + ts.opt_state.nu
    flat = _flat(learner)
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    _unflat_into(flat, learner)
    pick = (lambda g: g[r]) if isinstance(ts.rng, (tuple, list)) \
        else (lambda g: g)
    return ts._replace(
        env_state=_tree_map(shard, ts.env_state),
        last_obs=shard(ts.last_obs), rng=pick(ts.rng),
        ep_return=shard(ts.ep_return), ep_len=shard(ts.ep_len),
        env_rng=None if ts.env_rng is None else pick(ts.env_rng))


# ---------------------------------------------------------------------------
# data parallelism: the shard_map step


def make_distributed_ppo(mesh, cfg: ppo.PPOConfig, rl_cfg: rlenv.RLConfig,
                         params, init_xyzs, init_rpys, hidden=(64, 64),
                         device="cuda", rollout_override=None):
    """Build ``(global_init, train_step)`` over the mesh's "dp" dim.

    ``cfg.n_envs`` is the PER-RANK env count; the global batch is
    ``n_ranks * n_envs * n_steps``. ``global_init(seed)`` builds the full
    state on every rank (each rank's envs and generator from its own seed,
    ``rank_seeds``; the learner from the first rank's), which
    ``host_to_global`` turns into this rank's shard; ``train_step(ts)``
    steps that shard: ``rl.ppo.make_ppo``'s step over the "dp" group (a
    ``rollout_override`` as there). Runs on ``device``, the card unless
    the caller asks for the CPU."""
    group, _, n = axis(mesh, AXIS)
    init_fn, train_step, _ = ppo.make_ppo(
        cfg, rl_cfg, params, init_xyzs, init_rpys, hidden=hidden,
        device=device, group=group, rollout_override=rollout_override)

    def global_init(seed=0):
        states = [init_fn(s) for s in rank_seeds(seed, n)]

        def cat(*xs):
            return torch.cat(xs, dim=0)

        s0 = states[0]
        return ppo.TrainState(
            params=s0.params, opt_state=s0.opt_state,
            env_state=_tree_map(cat, *[s.env_state for s in states]),
            last_obs=cat(*[s.last_obs for s in states]),
            rng=tuple(s.rng for s in states),
            ep_return=cat(*[s.ep_return for s in states]),
            ep_len=cat(*[s.ep_len for s in states]),
            env_rng=(None if s0.env_rng is None
                     else tuple(s.env_rng for s in states)))

    return global_init, train_step


# ---------------------------------------------------------------------------
# tensor parallelism: Megatron's conjugate operators


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x, group):
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    return _ReduceFromTP.apply(x, group)


def actor_critic_tp_specs(net: ActorCritic):
    """{parameter name: the dim sharded over "tp", or None} for the port's
    ``ActorCritic``, the layout of the JAX function: in each tower the
    hidden layers alternate column-parallel (output features sharded:
    dim 0 of a torch ``(out, in)`` weight, where flax's ``(in, out)``
    kernel shards dim 1; and the bias) and row-parallel (the contraction
    sharded: dim 1 of the weight; the bias replicated, added after the
    reduce); heads and ``log_std`` replicated."""
    specs = {name: None for name, _ in net.named_parameters()}
    for tower in ("pi", "vf"):
        for j in range(len(net.hidden)):
            if j % 2 == 0:
                specs[f"{tower}.{j}.weight"] = 0
                specs[f"{tower}.{j}.bias"] = 0
            else:
                specs[f"{tower}.{j}.weight"] = 1
    return specs


def all_gather_cat(x, group, dim=0):
    """The ranks' ``x`` concatenated along ``dim`` in rank order (through
    the host for CUDA tensors on gloo, which gathers only CPU tensors)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    via_host = x.is_cuda and dist.get_backend(group) != "nccl"
    src = (x.cpu() if via_host else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(x.device)


class TPActorCritic(nn.Module):
    """This rank's shard of an ``ActorCritic`` over a "tp" group: the
    parameters of ``actor_critic_tp_specs`` cut to their slice, in the
    order of ``net.parameters()``; ``forward`` gives the unsharded
    module's ``(mean, log_std, value)`` on every rank of the group."""

    def __init__(self, net: ActorCritic, group):
        super().__init__()
        if len(net.hidden) % 2:
            raise ValueError("tensor parallelism pairs a column- with a "
                             "row-parallel layer: give an even number of "
                             "hidden layers")
        self.group = group
        self.rank, self.size = dist.get_rank(group), dist.get_world_size(
            group)
        self.hidden, self.obs_dim, self.act_dim = (net.hidden, net.obs_dim,
                                                   net.act_dim)
        for h in net.hidden:
            if h % self.size:
                raise ValueError(f"hidden width {h} does not split over "
                                 f"{self.size} ranks")
        self.specs = actor_critic_tp_specs(net)
        self.names = list(self.specs)
        self.shards = nn.ParameterList()
        with torch.no_grad():
            for name, p in net.named_parameters():
                self.shards.append(nn.Parameter(self._cut(name, p).clone()))

    def _cut(self, name, p):
        dim = self.specs[name]
        if dim is None:
            return p
        return p.chunk(self.size, dim)[self.rank]

    def sharded(self):
        """Per parameter, whether it is sharded over the group."""
        return [self.specs[n] is not None for n in self.names]

    def _p(self, name):
        return self.shards[self.names.index(name)]

    def _tower(self, obs, tower):
        x = obs
        for j in range(len(self.hidden)):
            w = self._p(f"{tower}.{j}.weight")
            b = self._p(f"{tower}.{j}.bias")
            if j % 2 == 0:
                x = torch.tanh(F.linear(copy_to_tp(x, self.group), w, b))
            else:
                x = torch.tanh(reduce_from_tp(F.linear(x, w), self.group)
                               + b)
        return F.linear(x, self._p(f"{tower}_out.weight"),
                        self._p(f"{tower}_out.bias"))

    def forward(self, obs):
        mean = self._tower(obs, "pi")
        value = self._tower(obs, "vf").squeeze(-1)
        return mean, self._p("log_std"), value

    def full_state_dict(self):
        """The unsharded weights (a gather over the group), keyed as the
        ``ActorCritic``'s."""
        return {name: (p.detach() if self.specs[name] is None else
                       all_gather_cat(p.detach(), self.group,
                                      self.specs[name]))
                for name, p in zip(self.names, self.shards)}


class TPClipAdam(ppo.ClipAdam):
    """``ClipAdam`` over a ``TPActorCritic``'s shards: the global norm
    adds the sharded gradients' squares over the "tp" group and counts the
    replicated ones once; Adam is elementwise, so it runs on the
    shards."""

    def __init__(self, lr, max_norm, sharded, group, **kw):
        super().__init__(lr, max_norm, **kw)
        self.sharded, self.group = sharded, group

    def global_norm(self, grads):
        sq = [torch.sum(g * g) for g in grads]
        sh = sum(s for s, m in zip(sq, self.sharded) if m)
        if torch.is_tensor(sh):
            sh = sh.clone()
            dist.all_reduce(sh, group=self.group)
        rep = sum(s for s, m in zip(sq, self.sharded) if not m)
        return torch.sqrt(sh + rep)


def make_pjit_ppo(mesh, cfg: ppo.PPOConfig, rl_cfg: rlenv.RLConfig, params,
                  init_xyzs, init_rpys, hidden=(64, 64), device="cuda"):
    """Build ``(init, train_step)`` over a ("dp", "tp") mesh.

    The single-process hover step (``rl.ppo.make_ppo``) partitioned:
    ``cfg.n_envs`` is the GLOBAL env count (it must divide by the "dp"
    extent, and each minibatch too); ``init(seed)`` gives this rank's
    ``TrainState`` (its envs, the ``TPActorCritic`` shard of the weights
    ``make_ppo``'s init draws from ``seed``, its Adam shards and the
    replicated generator); ``train_step(ts)`` returns (ts', metrics) with
    the single-process metrics. Runs on ``device``, the card unless the
    caller asks for the CPU."""
    dp, r_dp, n_dp = axis(mesh, AXIS)
    tp, _, _ = axis(mesh, TP_AXIS)
    if cfg.n_envs % n_dp:
        raise ValueError(f"n_envs={cfg.n_envs} not divisible by dp={n_dp}")
    mb = cfg.batch_size // cfg.n_minibatches
    if mb % n_dp:
        raise ValueError(f"minibatch {mb} not divisible by dp={n_dp}")
    n_local, mb_local = cfg.n_envs // n_dp, mb // n_dp
    lo = r_dp * n_local
    device = torch.device(device)
    adapter = ppo.hover_adapter(dataclasses.replace(cfg, n_envs=n_local),
                                rl_cfg, params, init_xyzs, init_rpys,
                                device=device)
    lr = (ppo.linear_schedule(cfg.lr, 0.0, cfg.total_updates)
          if cfg.total_updates is not None else cfg.lr)
    tx = None

    def init(seed=0):
        nonlocal tx
        gen = torch.Generator().manual_seed(seed)
        full = ActorCritic(adapter.obs_dim, adapter.act_dim, hidden,
                           generator=gen)
        net = TPActorCritic(full, tp).to(device)
        tx = TPClipAdam(lr, cfg.max_grad_norm, net.sharded(), tp)
        rng = torch.Generator(device=device)
        rng.manual_seed(seed)
        env_state, obs = adapter.batched_reset()
        return ppo.TrainState(
            params=net, opt_state=tx.init(list(net.parameters())),
            env_state=env_state, last_obs=obs.to(torch.float32), rng=rng,
            ep_return=torch.zeros(n_local, device=device),
            ep_len=torch.zeros(n_local, dtype=torch.int32, device=device))

    def sample(ts):
        def draw(mean, log_std):
            # the global batch's noise, as one process draws it
            noise = torch.randn((cfg.n_envs,) + mean.shape[1:],
                                generator=ts.rng, dtype=mean.dtype,
                                device=mean.device)[lo:lo + n_local]
            action = mean + torch.exp(log_std) * noise
            return action, gaussian_logp(action, mean, log_std)
        return draw

    def dp_sum(x):
        x = x.clone()
        dist.all_reduce(x, group=dp)
        return x

    def loss_fn(net, obs, act, logp_old, adv, ret, mu, std):
        """The global minibatch loss's share of this dp rank: its samples'
        terms over the global count, the entropy on dp rank 0 only."""
        mean, log_std, value = net(obs)
        logp = gaussian_logp(act, mean, log_std)
        ratio = torch.exp(logp - logp_old)
        a = (adv - mu) / (std + 1e-8)
        pg = -torch.sum(torch.minimum(
            ratio * a,
            torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * a))
        v = 0.5 * torch.sum((value - ret) ** 2)
        total = (pg + cfg.vf_coef * v) / mb
        if r_dp == 0:
            total = total - cfg.ent_coef * gaussian_entropy(log_std)
        return total

    def update_epoch(ts, opt_state, traj, advantages, returns):
        blk, n_mb, g = cfg.shuffle_block, cfg.n_minibatches, cfg.grad_accum
        if cfg.batch_size % blk or mb % blk:
            raise ValueError("shuffle_block must divide the minibatch size")
        if n_mb % g:
            raise ValueError("grad_accum must divide n_minibatches")
        n_blocks = cfg.batch_size // blk
        take = torch.randperm(n_blocks, generator=ts.rng,
                              device=device)[:(mb * n_mb) // blk]

        def permute(x):
            return x.reshape((n_blocks, blk) + x.shape[2:])[take].reshape(
                (n_mb, mb) + x.shape[2:])

        def shuffle(x):
            return permute(x)[:, r_dp * mb_local:(r_dp + 1) * mb_local]

        obs, act, logp = (shuffle(traj.obs), shuffle(traj.action),
                          shuffle(traj.logp))
        # each whole minibatch's advantage mean and population std, as
        # ppo_loss takes them: every rank holds the gathered trajectory
        adv_full = permute(advantages)
        mu = adv_full.mean(dim=1)
        std = adv_full.std(dim=1, correction=0)
        adv = adv_full[:, r_dp * mb_local:(r_dp + 1) * mb_local]
        ret = shuffle(returns)
        net = ts.params
        plist = list(net.parameters())
        losses = []
        for i0 in range(0, n_mb, g):
            acc = [torch.zeros_like(p) for p in plist]
            local = []
            for i in range(i0, i0 + g):
                loss = loss_fn(net, obs[i], act[i], logp[i], adv[i], ret[i],
                               mu[i], std[i])
                grads = torch.autograd.grad(loss, plist)
                acc = [a + gr for a, gr in zip(acc, grads)]
                local.append(loss.detach())
            # one collective a group: the gradients and the losses
            flat = dp_sum(torch.cat([_flat(acc), torch.stack(local)]))
            n_p = flat.numel() - g
            summed = [x.view_as(p) for x, p in zip(
                torch.split(flat[:n_p], [p.numel() for p in plist]), plist)]
            updates, opt_state = tx.update([a / g for a in summed],
                                           opt_state)
            with torch.no_grad():
                for p, u in zip(plist, updates):
                    p.add_(u)
            losses += list(flat[n_p:])
        return opt_state, losses

    def train_step(ts: ppo.TrainState, times=None):
        ts, traj, roll = ppo.policy_rollout(cfg.n_steps, adapter.step, ts,
                                            sample(ts))
        with torch.no_grad():
            _, _, last_value = ts.params(ts.last_obs)
            full = ppo.Transition(*[all_gather_cat(x, dp, dim=1)
                                    for x in traj])
            advantages, returns = ppo.compute_gae(
                cfg, full, all_gather_cat(last_value, dp))
        opt_state, losses = ts.opt_state, []
        for _ in range(cfg.n_epochs):
            opt_state, ls = update_epoch(ts, opt_state, full, advantages,
                                         returns)
            losses += ls
        ts = ts._replace(opt_state=opt_state)
        fin = all_gather_cat(roll["finished_return"], dp, dim=1)
        return ts, {"loss": torch.stack(losses).mean(),
                    "mean_episode_return": torch.nanmean(fin),
                    "mean_reward": full.reward.mean(),
                    "steps": cfg.batch_size}

    return init, train_step


# ---------------------------------------------------------------------------
# sharded env-stepping workloads


def _reduce(total, mesh):
    if mesh is not None:
        dist.all_reduce(total, group=mesh.get_group(AXIS))
    return total


def rollout_throughput_fn(mesh, rl_cfg: rlenv.RLConfig, params, init_xyzs,
                          init_rpys, n_envs_per_device: int, n_steps: int,
                          device="cuda"):
    """Hover env stepping on every rank of the mesh's "dp" dim (or alone,
    ``mesh`` None): ``n_envs_per_device`` envs of ``rl.autoreset_step``
    for ``n_steps`` steps of uniform +-0.05 actions drawn on ``device``
    (the card unless the caller asks for the CPU). Returns ``fn(seed) ->
    (total, local)``: ``seed`` this rank's, ``local`` its reward sum,
    ``total`` the sum over the ranks (one all-reduce)."""
    reset_template = rlenv.rl_reset(rl_cfg, init_xyzs, init_rpys, 1,
                                    device=device)
    n = rl_cfg.aviary.num_drones

    @torch.no_grad()
    def fn(seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        st = rlenv.rl_reset(rl_cfg, init_xyzs, init_rpys, n_envs_per_device,
                            device=device)
        rews = []
        for _ in range(n_steps):
            a = torch.rand((n_envs_per_device, n, rl_cfg.act_size),
                           generator=gen, device=device) * 0.1 - 0.05
            st, _, reward, _, _ = rlenv.autoreset_step(
                rl_cfg, params, reset_template, st, a)
            rews.append(reward.sum())
        local = torch.stack(rews).sum()
        return _reduce(local.clone(), mesh), local

    return fn


def race_rollout_throughput_fn(mesh, spec, track, n_envs_per_device: int,
                               n_steps: int, rollout_k: int = 0,
                               device="cuda"):
    """The row race env (envs/race_rl_rowfast.py) stepped on every rank
    of the mesh's "dp" dim (or alone, ``mesh`` None), uniform actions in
    [-1, 1]: one race_step launch per step, or with ``rollout_k`` > 0
    (dividing ``n_steps``) one race_rollout launch per ``rollout_k``
    steps, the chunk's actions drawn in one call. Returns ``fn(seed) ->
    (total, local)``: ``seed`` this rank's (its env's and its actions'
    generators), ``local`` its reward sum (the per-step env reward, or
    every reward row of the K-step launches, as the JAX function sums),
    ``total`` the sum over the ranks. Runs on ``device``, the card unless
    the caller asks for the CPU."""
    from ..envs import race_rl_rowfast

    if rollout_k and n_steps % rollout_k:
        raise ValueError(f"rollout_k={rollout_k} must divide "
                         f"n_steps={n_steps}")
    n = spec.num_drones
    shape = (n_envs_per_device, n, 4) if n > 1 else (n_envs_per_device, 4)

    @torch.no_grad()
    def fn(seed):
        env_seed, act_seed = np.random.SeedSequence(
            int(seed)).generate_state(2)
        env_gen = torch.Generator(device=device)
        env_gen.manual_seed(int(env_seed))
        gen = torch.Generator(device=device)
        gen.manual_seed(int(act_seed))
        env = race_rl_rowfast.make_row_env(spec, track, n_envs_per_device,
                                           device=device,
                                           generator=env_gen)
        st = env.reset()
        rews = []
        if rollout_k:
            for _ in range(n_steps // rollout_k):
                a = torch.rand((rollout_k,) + shape, generator=gen,
                               device=device) * 2 - 1
                st, REW, _ = env.rollout_steps(st, a)
                rews.append(REW.sum())
        else:
            for _ in range(n_steps):
                a = torch.rand(shape, generator=gen, device=device) * 2 - 1
                st, _, reward, _ = env.step(st, a)
                rews.append(reward.sum())
        local = torch.stack(rews).sum()
        return _reduce(local.clone(), mesh), local

    return fn
