"""Multi-process scaling: measured localhost clusters and a DCN byte model.

Counterpart of scripts/scaling.py (``run_cluster`` :48, ``dcn_model``
:71, ``main`` :88) and its worker (``_scaling_worker.py``):

1. **Measurement.** ``parallel.distributed.make_distributed_ppo`` on
   localhost clusters of 1, 2 and 4 processes (``--nprocs``), the TOTAL
   compute held fixed: torch has no virtual devices, so each process steps
   ``total_dev / nproc x envs_per_dev`` envs and the global batch stays
   ``total_dev x envs_per_dev x n_steps``. Step-time inflation against
   the 1-process row isolates the process boundary: the collectives and
   the ranks' synchronisation, with the ranks sharing one machine. Every
   row of a run takes one backend (``cluster_backend``): NCCL where each
   rank of the largest cluster has a card of its own, else gloo, so on a
   host with one card the ranks time-share it over gloo (NCCL refuses two
   ranks on one GPU). There it measures the process boundary, not
   multi-GPU scaling. The
   grad_accum=2 rerun halves the gradient syncs; the ``allreduce`` mode
   times 64 dependent all-reduces of the JAX script's gradient-sized
   buffer (26,757 float32, ~105 KiB) and divides by 64.
2. **DCN byte model** (``dcn_model``, a copy of the JAX script's): each
   optimizer update all-reduces the gradient (n_params x 4 B) across
   hosts; a ring all-reduce moves 2 (p - 1) / p of it per host per sync.
   Its compute times are the reference's TPU v5e iterations
   (VALIDATION.md:407-417), not the port's.

    python -m gym_pybullet_adrp_tpu_torch.scaling [--envs_per_dev 64] \\
        [--iters 10] [--nprocs 1,2,4] [--device cuda]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from .parallel import hosts

REPO = Path(__file__).resolve().parent.parent
# the all-reduce mode's buffer (scripts/_scaling_worker.py:58), float32
N_ELEMS = 26_757
# (name, compute ms per iteration, gradient syncs per iteration): the
# reference's TPU v5e race and hover PPO iterations at 4096 envs
PRODUCTION = (("race_ppo_4096envs_sb3_80sync", 11.9, 80),
              ("race_ppo_4096envs_accum8_10sync", 11.9, 10),
              ("hover_ppo_4096envs_accum8_10sync", 8.0, 10))


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def cluster_backend(device, nprocs):
    """The one backend of every row of a run over the process counts
    ``nprocs``: ``hosts.choose_backend`` for the largest cluster on the
    card (NCCL where each of its ranks has a card of its own, else gloo),
    gloo on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return hosts.choose_backend(max(nprocs))


def run_cluster(nproc, n_dev, envs_per_dev, n_steps, iters, mode="ppo",
                grad_accum=1, device="cuda", backend=None, timeout=900):
    """Run ``nproc`` worker processes on a localhost group and return rank
    0's JSON row. Each process steps ``n_dev x envs_per_dev`` envs on
    ``device`` (the card unless the caller asks for the CPU) over
    ``backend``, by default ``cluster_backend(device, [nproc])``; a caller
    comparing rows passes the one ``cluster_backend`` of all of them. A
    worker that fails or outlives ``timeout`` seconds fails the cluster;
    every worker is stopped before this returns."""
    backend = backend or cluster_backend(device, [nproc])
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out.json"
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "gym_pybullet_adrp_tpu_torch._scaling_worker", str(pid),
             str(nproc), str(port), str(out), str(n_dev), str(envs_per_dev),
             str(n_steps), str(iters), mode, str(grad_accum), device,
             backend],
            cwd=REPO, env=dict(os.environ), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for pid in range(nproc)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, lg in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"worker failed:\n{lg[-2000:]}")
        return json.loads(out.read_text())


def dcn_model(n_params, syncs_per_iter, compute_ms, n_hosts=4,
              dcn_gbps=25.0, latency_us=30.0, overlap_ms=0.0):
    """DCN cost of one PPO iteration's gradient syncs vs its compute
    time -> scaling efficiency. ``overlap_ms`` is communication hidden
    under concurrent compute; 0 = fully-serialized lower bound."""
    bytes_per_sync = 2 * (n_hosts - 1) / n_hosts * n_params * 4
    t_comm_ms = syncs_per_iter * (
        bytes_per_sync / (dcn_gbps * 1e9) * 1e3 + latency_us / 1e3
    )
    t_exposed = max(t_comm_ms - overlap_ms, 0.0)
    eff = compute_ms / (compute_ms + t_exposed)
    return bytes_per_sync, t_comm_ms, eff


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs_per_dev", type=int, default=64)
    ap.add_argument("--total_dev", type=int, default=4,
                    help="compute shares of envs_per_dev envs, held fixed "
                         "across process counts")
    ap.add_argument("--n_steps", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--nprocs", default="1,2,4",
                    help="process counts of the PPO rows")
    ap.add_argument("--device", default=device)
    ap.add_argument("--out", default="results/scaling.json")
    args = ap.parse_args(argv)
    nprocs = [int(n) for n in args.nprocs.split(",")]
    backend = cluster_backend(args.device, nprocs)
    kw = dict(device=args.device, backend=backend)

    print("Measures the process boundary on one machine (ranks on "
          f"{backend}, device {args.device}), not multi-GPU scaling.",
          flush=True)
    rows = []
    for nproc in nprocs:
        n_dev = args.total_dev // nproc
        r = run_cluster(nproc, n_dev, args.envs_per_dev, args.n_steps,
                        args.iters, **kw)
        rows.append(r)
        print(f"{nproc} proc x {n_dev * args.envs_per_dev} envs: "
              f"{r['sec_per_iter'] * 1e3:8.1f} ms/iter "
              f"(global batch {r['global_batch']})", flush=True)

    t1 = rows[0]["sec_per_iter"]
    print("\nFixed total compute (constant global batch; localhost "
          "processes):")
    for r in rows:
        eff = t1 / r["sec_per_iter"]
        r["process_boundary_efficiency"] = eff
        print(f"  {r['nproc']} proc: {eff * 100:5.1f}% "
              f"({r['sec_per_iter'] * 1e3:.1f} ms vs {t1 * 1e3:.1f} ms)")

    # gradient accumulation: one all-reduce per minibatch GROUP (2 -> 1
    # sync per epoch), at the fewest and the most processes
    accum_rows = []
    for nproc in sorted({min(nprocs), max(nprocs)}):
        r = run_cluster(nproc, max(args.total_dev // nproc, 1),
                        args.envs_per_dev, args.n_steps, args.iters,
                        grad_accum=2, **kw)
        accum_rows.append(r)
        print(f"  grad_accum=2, {nproc} proc: "
              f"{r['sec_per_iter'] * 1e3:.1f} ms/iter "
              f"({r['grad_syncs_per_iter']} syncs/iter)", flush=True)

    # the gradient-sized all-reduce alone, across a process boundary
    sync_rows = []
    for nproc in [n for n in nprocs if n > 1]:
        r = run_cluster(nproc, max(args.total_dev // nproc, 1),
                        args.envs_per_dev, args.n_steps, args.iters,
                        mode="allreduce", **kw)
        sync_rows.append(r)
        print(f"  all-reduce {r['bytes'] / 1024:.0f} KiB, {nproc} proc: "
              f"{r['sec_per_sync'] * 1e6:.0f} us/sync", flush=True)

    n_params = rows[0]["n_params"]
    syncs = rows[0]["grad_syncs_per_iter"]
    model = {}
    for name, compute_ms, syncs_prod in PRODUCTION:
        b, t_comm, eff = dcn_model(n_params, syncs_prod, compute_ms)
        _, t2, eff_deg = dcn_model(n_params, syncs_prod, compute_ms,
                                   dcn_gbps=12.5, latency_us=60.0)
        _, _, eff_ov = dcn_model(n_params, syncs_prod, compute_ms,
                                 dcn_gbps=12.5, latency_us=60.0,
                                 overlap_ms=2.5)
        model[name] = {
            "compute_ms_tpu_v5e_reference": compute_ms,
            "bytes_per_sync_per_host": b,
            "dcn_ms_per_iter_serialized": t_comm,
            "efficiency_4_hosts_dcn_model": eff,
            "efficiency_4_hosts_dcn_2x_degraded": eff_deg,
            "efficiency_4_hosts_degraded_with_overlap": eff_ov,
        }
        print(f"\n{name} (compute {compute_ms} ms: the reference's TPU "
              f"v5e iteration): {b / 1024:.0f} KiB/sync/host, {syncs_prod} "
              f"syncs; DCN model (25 GB/s, 30 us) {t_comm:.2f} ms -> "
              f"{eff * 100:.1f}% @ 4 hosts; 2x degraded {t2:.2f} ms -> "
              f"{eff_deg * 100:.1f}%; with 2.5 ms overlap "
              f"{eff_ov * 100:.1f}%")
    out = {"measured_ppo": rows, "measured_ppo_grad_accum": accum_rows,
           "measured_allreduce": sync_rows, "dcn_model": model,
           "n_params": n_params, "syncs_per_iter_measured": syncs}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"\nwrote {args.out}")
    return out


if __name__ == "__main__":
    main()
