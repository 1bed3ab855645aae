"""Device times of the hover kernels K1, K2, K7 and K8 and the host's
enqueue of the K2 wrapper on one card, for this checkout or others, in
turns.

  python3 -m gym_pybullet_adrp_tpu_torch.hover_kernel_times [--tree DIR]...
      [--out FILE]

Each ``--tree`` (default: this checkout) runs in a process of its own, in
the order given, importing the ``gym_pybullet_adrp_tpu_torch`` package
found in DIR and building its kernels there (``race_kernel_times.
run_trees``), so a parent commit's package unpacked by ``git archive``
can be held against this one on the same card (list the trees as parent,
change, change, parent). A tree written DIR@L runs the rollout kernel
with L lanes per env whatever the batch (a package that picks L with
``hover_step.lane_count``). Each process prints one JSON line: the
card's name and power limit, the ptxas report of the hover kernels
(registers, stack frame, spills per instantiation), the lane counts the
package picks, and
  K1 at 4096 envs (device ms, launches queued behind a spin kernel);
  K2 at 1024 to 65536 envs x 64 steps, both integrators;
  K7 (exact integrator, e2 < 1e-8) and K8 at 4096 x 64;
  bench.py's headline loop (60 K2 launches x 64 steps at 4096 envs, each
    followed by ``total + acc.sum()``; CUDA events around the loop): ms
    per launch and env-steps/s, the best of 3 loops;
  the enqueue: host ms per K2 call while the calls queue behind the spin,
    alone and with the headline loop's ``total + acc.sum()``, and of the
    wrapper's two output allocations alone, the least of 5 runs of 50
    calls each (the host's clock varies more than the card's).
Needs a CUDA device and nvcc; imports no JAX.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

N_STEPS = 64
HEADLINE_LAUNCHES = 60
HOVER_KERNELS = ("hover_rollout_kernel", "hover_step_kernel")


def _race_tool():
    """This checkout's race_kernel_times, loaded from its file: a worker's
    ``gym_pybullet_adrp_tpu_torch`` is the tree's, which may predate the
    helpers used here."""
    path = Path(__file__).resolve().parent / "race_kernel_times.py"
    spec = importlib.util.spec_from_file_location("_race_kernel_times", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(lanes=None):
    """The JSON record of the package on ``sys.path`` (see the module
    docstring); ``lanes`` forces the rollout kernel's lane count."""
    import torch
    from gym_pybullet_adrp_tpu_torch.envs import fast_hover
    from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
    from gym_pybullet_adrp_tpu_torch.ops import _build
    from gym_pybullet_adrp_tpu_torch.ops import hover_step as hs
    from gym_pybullet_adrp_tpu_torch.ops import hover_variants as hv
    from gym_pybullet_adrp_tpu_torch.ops import quat as quat_ops

    if not torch.cuda.is_available():
        raise SystemExit("hover_kernel_times: no CUDA device")
    rt = _race_tool()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(11)
    _build.library("hover_rollout")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    rec = {"card": card,
           "ptxas": rt.ptxas_entries(_build.build_info["ptxas"],
                                     HOVER_KERNELS),
           "ms": {}}
    if lanes is not None:
        hs.lane_count = lambda B, n_sm=132: int(lanes)
    if hasattr(hs, "lane_count"):
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        rec["lanes"] = {B: hs.lane_count(B, n_sm)
                        for B in (1024, 4096, 8192, 16384, 65536)}
    P = drone_params(device=dev)
    c = hs.hover_consts(P)
    c1 = hs.hover_consts(P, 8, 1 / 240)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    n = 4096
    pos = u(-1, 1, n, 3) + torch.tensor([0.0, 0.0, 1.5], device=dev)
    quat = quat_ops.from_euler_xyz(u(-0.3, 0.3, n, 3))
    packed = hs.pack_state(pos, quat, u(-1, 1, n, 3), u(-2, 2, n, 3))
    rpm = (u(0.9, 1.1, 4, n // 128, 128) * P.hover_rpm).contiguous()
    rec["ms"]["k1_4096"] = rt.device_ms(
        lambda: hs.ctrl_step_packed(P, packed, rpm, 8, 1 / 240, consts=c1),
        n=50)

    def rest(B):
        return fast_hover.reset_packed([0.0, 0.0, 0.1125], B,
                                       device=dev).packed

    for B in (1024, 2048, 4096, 8192, 16384, 65536):
        st = rest(B)
        for small in (True, False):
            key = f"k2_{'small' if small else 'exact'}_{B}"
            rec["ms"][key] = rt.device_ms(
                lambda: hs.hover_rollout(P, st, 3, N_STEPS, smallangle=small,
                                         consts=c), n=20 if B < 65536 else 10)
    st = rest(4096)
    rec["ms"]["k7_4096"] = rt.device_ms(
        lambda: hv.hover_rollout_v2(P, st, 3, N_STEPS, consts=c))
    rec["ms"]["k8_4096"] = rt.device_ms(
        lambda: hv.hover_rollout_v3(P, st, 3, N_STEPS, consts=c))
    enq = [rt.device_host_ms(
        lambda: hs.hover_rollout(P, st, 3, N_STEPS, consts=c), n=50)[1]
        for _ in range(5)]
    rec["ms"]["enqueue_k2"] = min(enq)
    rec["enqueue_k2_ms"] = enq
    total = torch.zeros((), device=dev)

    def with_sum():
        nonlocal total
        _, acc = hs.hover_rollout(P, st, 3, N_STEPS, consts=c)
        total = total + acc.sum()

    enq = [rt.device_host_ms(with_sum, n=50)[1] for _ in range(5)]
    rec["ms"]["enqueue_k2_sum"] = min(enq)
    rec["enqueue_k2_sum_ms"] = enq

    # what any wrapper pays: its two outputs' allocation, behind the spin
    def alloc():
        torch.empty_like(st)
        st.new_empty(st.shape[1:])

    rec["ms"]["enqueue_alloc"] = min(
        rt.device_host_ms(alloc, n=50)[1] for _ in range(5))

    # bench.py --impl pallas-rollout: the headline loop
    def headline():
        s = rest(4096)
        total = torch.zeros((), device=dev)
        for i in range(HEADLINE_LAUNCHES):
            s, acc = hs.hover_rollout(P, s, 7 + i, N_STEPS, consts=c)
            total = total + acc.sum()
        return total

    headline()
    loops = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        headline()
        stop.record()
        torch.cuda.synchronize()
        loops.append(start.elapsed_time(stop) / HEADLINE_LAUNCHES)
    rec["ms"]["headline_loop"] = min(loops)
    rec["headline_loops_ms"] = loops
    rec["headline_env_steps_per_sec"] = (4096 * N_STEPS
                                         / min(loops) * 1e3)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=None,
                    help="a directory holding gym_pybullet_adrp_tpu_torch/, "
                         "or DIR@L to force L lanes per env in the rollout "
                         "kernel (repeatable; default: this checkout)")
    ap.add_argument("--out", default=None, help="also write the records "
                    "here, one JSON line per tree")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("lanes", nargs="?", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(measure(args.lanes)), flush=True)
        return 0
    here = Path(__file__).resolve()
    return _race_tool().run_trees(here, args.tree or [str(here.parent.parent)],
                                  args.out, "hover_kernel_times")


if __name__ == "__main__":
    sys.exit(main())
