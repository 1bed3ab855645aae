"""One rank of the port's multi-process tests (tests/test_torch_distributed.py
starts the ranks; pytest does not collect this file).

    python tests/_torch_dist_worker.py RANK WORLD PORT INPUTS.npz OUT_DIR CASES

joins a gloo group on 127.0.0.1:PORT, runs the comma-separated CASES on
the CPU with the numpy inputs of INPUTS.npz (made from a seed by the test)
and writes its results to OUT_DIR/rank<RANK>.npz. It imports no JAX. The
sizes below are shared with the test, which imports them.
"""

import sys
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

# PPO configs (per rank where the step is make_distributed_ppo's, global
# for make_pjit_ppo's), as the JAX tests size them (tests/test_rl.py)
GROUPED = dict(g=2, mb=16)
INJECTED = dict(n_envs=8, n_steps=8, n_epochs=2, n_minibatches=1,
                ent_coef=0.01)
E2E = dict(n_envs=4, n_steps=8, n_epochs=1, n_minibatches=2)
ACCUM = dict(n_envs=4, n_steps=8, n_epochs=2, n_minibatches=4,
             grad_accum=2)
# the entropy term on: the tensor-parallel loss counts it once
PJIT = dict(n_envs=8, n_steps=8, n_epochs=2, n_minibatches=2,
            ent_coef=0.01)
PJIT_SEED = 3
RACE = dict(n_envs=128, n_steps=2)
HOVER_ROLL = dict(n_envs=16, n_steps=4)
CLIP, VF = 0.2, 0.5


def hover_setup():
    from gym_pybullet_adrp_tpu_torch.envs.core import AviaryConfig
    from gym_pybullet_adrp_tpu_torch.envs.rl import RLConfig
    from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
    from gym_pybullet_adrp_tpu_torch.utils.enums import ActionType

    rl_cfg = RLConfig(aviary=AviaryConfig(ctrl_freq=30),
                      act_type=ActionType.RPM)
    return (rl_cfg, drone_params(device="cpu"), [[0.0, 0.0, 0.1125]],
            [[0.0, 0.0, 0.0]])


def load_net(inp, prefix, obs_dim):
    from gym_pybullet_adrp_tpu_torch.models.policy import ActorCritic

    net = ActorCritic(obs_dim, 4)
    net.load_state_dict({k[len(prefix):]: torch.from_numpy(v)
                         for k, v in inp.items() if k.startswith(prefix)})
    return net


def params_out(prefix, state):
    return {prefix + k: v.detach().cpu().numpy() for k, v in state.items()}


class Calls:
    """Records the size of every all-reduce."""

    def __init__(self):
        self.sizes = []
        self.orig = dist.all_reduce

        def counting(t, *a, **k):
            self.sizes.append(t.numel())
            return self.orig(t, *a, **k)

        dist.all_reduce = counting


def case_grouped(inp, rank, world, calls):
    from gym_pybullet_adrp_tpu_torch.parallel import distributed
    from gym_pybullet_adrp_tpu_torch.rl import ppo

    g = GROUPED["g"]
    mesh = distributed.make_mesh(world)
    net = load_net(inp, "grouped/w/", inp["grouped/obs"].shape[-1])

    class SGD:
        def update(self, grads, state):
            return [-x for x in grads], state

    xs = [(ppo.Transition(*[torch.from_numpy(inp[f"grouped/{k}"][i])
                            for k in ("obs", "action", "logp")],
                          None, None, None),
           torch.from_numpy(inp["grouped/adv"][i]),
           torch.from_numpy(inp["grouped/ret"][i]))
          for i in range(rank * g, (rank + 1) * g)]

    def loss_fn(n, batch, adv, ret):
        return ppo.ppo_loss(n, CLIP, VF, 0.0, batch, adv, ret)

    calls.sizes.clear()
    _, losses = ppo.grouped_update(loss_fn, SGD(), g, net, None, xs,
                                   mesh.get_group("dp"))
    out = params_out("grouped/p/", net.state_dict())
    out["grouped/n_allreduce"] = np.array(len(calls.sizes))
    out["grouped/losses"] = torch.stack(losses).numpy()
    return out


def case_injected(inp, rank, world, calls):
    from gym_pybullet_adrp_tpu_torch.parallel import distributed
    from gym_pybullet_adrp_tpu_torch.rl import ppo

    rl_cfg, P, xyz, rpy = hover_setup()
    cfg = ppo.PPOConfig(**INJECTED)
    mesh = distributed.make_mesh(world)

    def override(ts):
        traj = ppo.Transition(**{
            k: torch.from_numpy(inp[f"injected/{k}"][rank])
            for k in ppo.Transition._fields})
        ts = ts._replace(
            last_obs=torch.from_numpy(inp["injected/last_obs"][rank]))
        return ts, traj, {"finished_return": torch.from_numpy(
            inp["injected/fin"][rank])}

    gi, step = distributed.make_distributed_ppo(
        mesh, cfg, rl_cfg, P, xyz, rpy, device="cpu",
        rollout_override=override)
    ts = distributed.host_to_global(mesh, gi(0))
    net = load_net(inp, "injected/w/", rl_cfg.obs_size)
    ts.params.load_state_dict(net.state_dict())
    ts, m = step(ts)
    out = params_out("injected/p/", ts.params.state_dict())
    out.update({f"injected/{k}": v.numpy() for k, v in m.items()})
    return out


def _e2e(name, kw, rank, world, calls):
    from gym_pybullet_adrp_tpu_torch.parallel import distributed
    from gym_pybullet_adrp_tpu_torch.rl import ppo

    rl_cfg, P, xyz, rpy = hover_setup()
    cfg = ppo.PPOConfig(**kw)
    mesh = distributed.make_mesh(world)
    gi, step = distributed.make_distributed_ppo(mesh, cfg, rl_cfg, P, xyz,
                                                rpy, device="cpu")
    full = gi(0)
    ts = distributed.host_to_global(mesh, full)
    n_params = sum(p.numel() for p in ts.params.parameters())
    losses, grad_syncs = [], []
    for _ in range(2):
        calls.sizes.clear()
        ts, m = step(ts)
        losses.append(float(m["loss"]))
        grad_syncs.append(sum(s == n_params for s in calls.sizes))
    out = params_out(f"{name}/p/", ts.params.state_dict())
    out.update({f"{name}/losses": np.array(losses),
                f"{name}/grad_syncs": np.array(grad_syncs),
                f"{name}/global_envs": np.array(full.last_obs.shape[0]),
                f"{name}/local_envs": np.array(ts.last_obs.shape[0])})
    return out


def case_e2e(inp, rank, world, calls):
    return _e2e("e2e", E2E, rank, world, calls)


def case_accum(inp, rank, world, calls):
    return _e2e("accum", ACCUM, rank, world, calls)


def case_tp_forward(inp, rank, world, calls):
    from gym_pybullet_adrp_tpu_torch.parallel import distributed

    mesh = distributed.make_mesh_2d(1, world)
    net = load_net(inp, "tpfwd/w/", inp["tpfwd/obs"].shape[-1])
    tp = distributed.TPActorCritic(net, mesh.get_group("tp"))
    mean, log_std, value = tp(torch.from_numpy(inp["tpfwd/obs"]))
    loss = (torch.sum(mean * torch.from_numpy(inp["tpfwd/wm"]))
            + torch.sum(value * torch.from_numpy(inp["tpfwd/wv"]))
            + torch.sum(log_std))
    grads = torch.autograd.grad(loss, list(tp.parameters()))
    full = {}
    for name, gr in zip(tp.names, grads):
        dim = tp.specs[name]
        full[name] = (gr if dim is None else distributed.all_gather_cat(
            gr, mesh.get_group("tp"), dim))
    out = params_out("tpfwd/g/", full)
    out.update({"tpfwd/mean": mean.detach().numpy(),
                "tpfwd/value": value.detach().numpy()})
    return out


def _pjit(name, n_dp, n_tp, rank, world, calls):
    from gym_pybullet_adrp_tpu_torch.parallel import distributed
    from gym_pybullet_adrp_tpu_torch.rl import ppo

    rl_cfg, P, xyz, rpy = hover_setup()
    cfg = ppo.PPOConfig(**PJIT)
    mesh = distributed.make_mesh_2d(n_dp, n_tp)
    init, step = distributed.make_pjit_ppo(mesh, cfg, rl_cfg, P, xyz, rpy,
                                           device="cpu")
    ts = init(PJIT_SEED)
    losses = []
    for _ in range(2):
        ts, m = step(ts)
        losses.append(float(m["loss"]))
    out = params_out(f"{name}/p/", ts.params.full_state_dict())
    out[f"{name}/losses"] = np.array(losses)
    out[f"{name}/mean_reward"] = np.array(float(m["mean_reward"]))
    if rank == 0:
        rinit, rstep, _ = ppo.make_ppo(cfg, rl_cfg, P, xyz, rpy,
                                       device="cpu")
        rts = rinit(PJIT_SEED)
        ref = []
        for _ in range(2):
            rts, rm = rstep(rts)
            ref.append(float(rm["loss"]))
        out.update(params_out(f"{name}/ref/", rts.params.state_dict()))
        out[f"{name}/ref_losses"] = np.array(ref)
        out[f"{name}/ref_mean_reward"] = np.array(float(rm["mean_reward"]))
    return out


def case_pjit_tp(inp, rank, world, calls):
    return _pjit("pjit_tp", 1, world, rank, world, calls)


def case_pjit_dp(inp, rank, world, calls):
    return _pjit("pjit_dp", world, 1, rank, world, calls)


def case_pjit_2x2(inp, rank, world, calls):
    return _pjit("pjit_2x2", 2, world // 2, rank, world, calls)


def case_race(inp, rank, world, calls):
    from gym_pybullet_adrp_tpu_torch.envs import race as race_mod
    from gym_pybullet_adrp_tpu_torch.parallel import distributed
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config
    from gym_pybullet_adrp_tpu_torch.utils.enums import Physics, RaceMode

    cfg = load_config("getting_started")
    spec = race_mod.RaceSpec.from_config(cfg, 2, RaceMode.COMPETE,
                                         Physics.PYB)
    track = race_mod.track_from_config(cfg, 2)
    mesh = distributed.make_mesh(world)
    seed = distributed.rank_seeds(0, world)[rank]
    out = {}
    for k in (0, 2):
        args = (spec, track, RACE["n_envs"], RACE["n_steps"])
        total, local = distributed.race_rollout_throughput_fn(
            mesh, *args, rollout_k=k, device="cpu")(seed)
        _, alone = distributed.race_rollout_throughput_fn(
            None, *args, rollout_k=k, device="cpu")(seed)
        out.update({f"race/{k}/total": total.numpy(),
                    f"race/{k}/local": local.numpy(),
                    f"race/{k}/alone": alone.numpy()})
    return out


def case_hover_roll(inp, rank, world, calls):
    from gym_pybullet_adrp_tpu_torch.parallel import distributed

    rl_cfg, P, xyz, rpy = hover_setup()
    mesh = distributed.make_mesh(world)
    seed = distributed.rank_seeds(0, world)[rank]
    args = (rl_cfg, P, xyz, rpy, HOVER_ROLL["n_envs"], HOVER_ROLL["n_steps"])
    total, local = distributed.rollout_throughput_fn(
        mesh, *args, device="cpu")(seed)
    _, alone = distributed.rollout_throughput_fn(None, *args,
                                                 device="cpu")(seed)
    sub = distributed.make_mesh(1)       # the first rank's mesh
    return {"hover_roll/total": total.numpy(),
            "hover_roll/local": local.numpy(),
            "hover_roll/alone": alone.numpy(),
            "mesh1/in_mesh": np.array(sub.get_coordinate() is not None)}


def main(argv):
    rank, world, port = int(argv[1]), int(argv[2]), argv[3]
    inp = dict(np.load(argv[4]))
    out_dir, cases = Path(argv[5]), argv[6].split(",")
    torch.set_num_threads(1)
    from gym_pybullet_adrp_tpu_torch.parallel import hosts

    assert hosts.ensure_initialized(f"127.0.0.1:{port}", world, rank,
                                    backend="gloo")
    calls = Calls()
    out = {}
    for case in cases:
        out.update(globals()[f"case_{case}"](inp, rank, world, calls))
    np.savez(out_dir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"WORKER{rank} OK", flush=True)


if __name__ == "__main__":
    try:
        main(sys.argv)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
