"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1> [--control bfloat16]

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (after the same window, a
traced segment of the traffic's ``trace_calls`` calls). The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``[, ``breakdown``], ``checks``); the
last lines of standard error give each number the check compared beside
its limit. ``--control`` runs the reference in the program's place at a
lower precision, the comparison's control: it must read not correct.

A run needs a CUDA card (it never falls back to the CPU) and exits with
another code than 0, printing no result, when there is none, when the
process has loaded JAX or the JAX package, or when anything fails.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / ".bench_cache"


def fix_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc build directory is
    gym_pybullet_adrp_tpu_torch/_build), and no JAX through a library."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bfloat16",), default=None)
    args = ap.parse_args(argv)
    fix_cache_dirs()

    import torch

    from benchmark import harness

    try:
        cells = {w["name"]: w for w in harness.load_benchmark()["workloads"]}
    except (OSError, KeyError, ValueError) as e:
        log(f"error: BENCHMARK.json: {e}")
        return 2
    if args.workload not in cells:
        log(f"error: no workload {args.workload!r} ({sorted(cells)})")
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available():
        log("error: no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"error: {args.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    torch.set_num_threads(1)
    try:
        res = harness.run_cell(args.workload, args.seed, args.seconds,
                               args.trace, control=args.control,
                               t_start=T_START, log=log)
    except harness.RunError as e:
        log(f"error: {e}")
        return 3
    if args.trace:
        log(f"card: {power_limit()}")
    for name, c in res["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
