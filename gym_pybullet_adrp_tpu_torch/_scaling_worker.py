"""Worker of ``scaling.py``: one rank of a localhost cluster.

Counterpart of scripts/_scaling_worker.py. Launched as

    python -m gym_pybullet_adrp_tpu_torch._scaling_worker PID NPROC PORT \\
        OUT.json N_DEV ENVS_PER_DEV N_STEPS ITERS [MODE] [GRAD_ACCUM] \\
        [DEVICE] [BACKEND]

mode "ppo" (default): timed ``make_distributed_ppo`` train steps, the
rank stepping N_DEV x ENVS_PER_DEV hover envs. Mode "allreduce": the
per-sync cost of a gradient-sized all-reduce, 64 dependent all-reduces
timed and divided by 64. BACKEND is the run's one backend, which the
launcher picks (``scaling.cluster_backend`` over the run's process
counts); without it, that of this cluster alone. Rank 0 writes the row to OUT.json.
Every rank joins the group, a world of one too, so each row runs the
same code.
"""

import json
import os
import sys
import time

import torch
import torch.distributed as dist

from .parallel import distributed, hosts
from .scaling import N_ELEMS, cluster_backend


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_allreduce(group, device, n_elems=N_ELEMS, k=64, rounds=3):
    """Seconds per sync of ``k`` dependent SUM all-reduces of ``n_elems``
    float32 over ``group`` (each divided by the group's size, JAX's
    ``psum / n``), the best of ``rounds``."""
    n = dist.get_world_size(group)
    x0 = torch.ones(n_elems, device=device)

    def body():
        x = x0
        for _ in range(k):
            x = x.clone()
            dist.all_reduce(x, group=group)
            x = x / n
        return x

    body()
    _sync(device)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        body()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / k)
    return best


def main(argv):
    pid, nproc, port, out_path = (int(argv[1]), int(argv[2]), argv[3],
                                  argv[4])
    n_dev, envs_per_dev, n_steps, iters = (int(x) for x in argv[5:9])
    mode = argv[9] if len(argv) > 9 else "ppo"
    grad_accum = int(argv[10]) if len(argv) > 10 else 1
    device = argv[11] if len(argv) > 11 else "cuda"
    backend = (argv[12] if len(argv) > 12
               else cluster_backend(device, [nproc]))
    if device == "cpu":
        # the processes share the host's cores (or OMP_NUM_THREADS): the
        # same total as one process
        cores = int(os.environ.get("OMP_NUM_THREADS", os.cpu_count() or 1))
        torch.set_num_threads(max(1, cores // nproc))
    hosts.ensure_initialized(f"127.0.0.1:{port}", nproc, pid,
                             backend=backend)
    dev = hosts.rank_device(device)
    mesh = distributed.make_mesh()

    if mode == "allreduce":
        best = time_allreduce(mesh.get_group("dp"), dev)
        if pid == 0:
            with open(out_path, "w") as f:
                json.dump({"nproc": nproc, "sec_per_sync": best,
                           "bytes": N_ELEMS * 4,
                           "global_devices": nproc * n_dev,
                           "device": str(dev), "backend": backend}, f)
        print(f"SCALEWORKER{pid} allreduce nproc={nproc} "
              f"{best * 1e6:.0f} us/sync", flush=True)
        dist.destroy_process_group()
        return

    from .envs.core import AviaryConfig
    from .envs.rl import RLConfig
    from .models.drone import drone_params
    from .rl.ppo import PPOConfig
    from .utils.enums import ActionType

    # fixed total compute across process counts (the launcher divides
    # the compute shares), so step-time inflation isolates the boundary
    cfg = PPOConfig(n_envs=n_dev * envs_per_dev, n_steps=n_steps,
                    n_minibatches=2, n_epochs=2, grad_accum=grad_accum)
    rl_cfg = RLConfig(aviary=AviaryConfig(ctrl_freq=30),
                      act_type=ActionType.RPM)
    params = drone_params(device=dev)
    global_init, train_step = distributed.make_distributed_ppo(
        mesh, cfg, rl_cfg, params, [[0.0, 0.0, 0.1125]], [[0.0, 0.0, 0.0]],
        device=dev)
    ts = distributed.host_to_global(mesh, global_init(0))
    for _ in range(2):                                   # warm-up
        ts, metrics = train_step(ts)
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, metrics = train_step(ts)
    float(metrics["loss"])
    dt = (time.perf_counter() - t0) / iters

    if pid == 0:
        with open(out_path, "w") as f:
            json.dump({
                "nproc": nproc, "sec_per_iter": dt,
                "global_devices": nproc * n_dev,
                "global_batch": nproc * cfg.batch_size,
                "n_params": sum(p.numel() for p in ts.params.parameters()),
                "grad_accum": grad_accum,
                "grad_syncs_per_iter": cfg.n_epochs
                * (cfg.n_minibatches // cfg.grad_accum),
                "device": str(dev), "backend": backend,
            }, f)
    print(f"SCALEWORKER{pid} nproc={nproc} {dt * 1e3:.1f} ms/iter",
          flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
