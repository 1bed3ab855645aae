"""Run a cell several times, each run a process of its own as a check
makes it, and report the spread of each metric.

    python3 -m benchmark.sets --workload <name> --seeds 11,12,13 \\
        --seconds 20 [--trace 0] [--control bfloat16] [--out runs.jsonl]

prints one line a run (seed, correct, the metrics, the checks, set-up)
and, per metric, the median and the quartile spread ((Q3 - Q1) / median
by ``statistics.quantiles(values, n=4)``) over the runs. ``--out`` appends each run's result line,
with its seed, exit code and stderr's tail, to a JSON-lines file.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

from benchmark.stats import quartile_spread


def run_once(args, seed):
    cmd = [sys.executable, "-m", "benchmark.run", "--workload",
           args.workload, "--seed", str(seed), "--seconds",
           str(args.seconds), "--trace", str(args.trace)]
    if args.control:
        cmd += ["--control", args.control]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    res = None
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        res = json.loads(lines[-1])
    return {"seed": seed, "rc": p.returncode, "wall_s": wall,
            "result": res, "stderr_tail": p.stderr[-3000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_once(args, seed)
        runs.append(r)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(dict(r, workload=args.workload,
                                        seconds=args.seconds,
                                        trace=args.trace,
                                        control=args.control)) + "\n")
        res = r["result"]
        if res is None:
            print(f"seed {r['seed']}: rc {r['rc']}, no result\n"
                  + r["stderr_tail"][-1500:], flush=True)
            continue
        vals = {k: v["value"] for k, v in res["metrics"].items()}
        checks = {k: v["value"] for k, v in res["checks"].items()}
        print(f"seed {r['seed']}: correct {res['correct']} wall "
              f"{r['wall_s']:.1f} s calls {res['attempted']} {vals} "
              f"checks {checks} peak {res['device']['memory_peak_bytes']}",
              flush=True)
    ok = [r["result"] for r in runs if r["result"]]
    if len(ok) >= 2:
        for k in ok[0]["metrics"]:
            xs = [r["metrics"][k]["value"] for r in ok if k in r["metrics"]]
            spread = quartile_spread(xs) if len(xs) >= 2 else float("nan")
            print(f"{k}: median {statistics.median(xs)!r} spread "
                  f"{spread!r} over {len(xs)} runs", flush=True)
    return 0 if all(r["result"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
