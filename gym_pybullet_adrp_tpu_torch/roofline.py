"""Roofline table of the port's kernels on the card.

Counterpart of scripts/roofline.py: recounts the operations per env-step
of the kernels' plain versions (utils/roofline.py, ``OpCount`` at B =
128, on the card unless ``--device cpu`` asks for the CPU; a few
seconds), checks the stored
constants for drift (> 2%: exit 1), and prints each kernel's bytes and
operations per env-step, the rate at which it would reach the card's
FP32 issue rate, and, for each measured rate given, its shares of the
issue rate (plain and calibrated by K6's per-op costs) and of HBM3's
rate.

Usage:
  python -m gym_pybullet_adrp_tpu_torch.roofline [--hover RATE]
      [--race1 RATE] [--race2 RATE] [--envs 4096] [--device cuda]

RATE is a measured env-steps/s at ``--envs`` envs: hover, K2's rollout
(64 steps a launch); race1 and race2, K5's action-mode rollout (K=32, 1
drone COMPARE, 2 drones COMPETE) on getting_started.
"""

import argparse
import sys

from .utils import roofline as rf


def rows(envs):
    """(case, kernel, bytes per env-step) of the table."""
    return [("hover", "hover_rollout (K2, 64 steps)",
             rf.hover_rollout_bytes_per_step(envs)),
            ("race1", "race_rollout (K5, K=32, 1 drone)",
             rf.race_rollout_bytes_per_step(envs, 1)),
            ("race2", "race_rollout (K5, K=32, 2 drones)",
             rf.race_rollout_bytes_per_step(envs, 2))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--hover", type=float, default=None)
    ap.add_argument("--race1", type=float, default=None)
    ap.add_argument("--race2", type=float, default=None)
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="where the plain versions are counted")
    args = ap.parse_args(argv)

    m = rf.measure_ops_per_env_step(args.device, verbose=True)
    drift = False
    print("\nper env-step (stored constants in parentheses):")
    for k in m["ops"]:
        so, sc = rf.OPS_PER_ENV_STEP[k], rf.CAL_OPS_PER_ENV_STEP[k]
        bad = (abs(m["ops"][k] - so) / so > 0.02
               or abs(m["cal_ops"][k] - sc) / sc > 0.02)
        drift = drift or bad
        print(f"  {k:6s} ops {m['ops'][k]:9.1f} ({so:.1f})  calibrated "
              f"{m['cal_ops'][k]:9.1f} ({sc:.1f})"
              + ("  <-- DRIFT: update utils/roofline.py" if bad else ""))

    rates = {"hover": args.hover, "race1": args.race1, "race2": args.race2}
    print(f"\n{rf.H100['card']}: FP32 {rf.H100['fp32_issues_per_s']:.4g} "
          f"issues/s, HBM {rf.H100['hbm_bytes_per_s']:.4g} B/s; "
          f"{args.envs} envs; cal%: the census weighted by the per-op "
          f"costs of {rf.CAL_SOURCE}")
    print(f"{'kernel':34s} {'ops/st':>8s} {'B/st':>7s} {'SoL st/s':>10s} "
          f"{'steps/s':>10s} {'FP32%':>7s} {'cal%':>7s} {'HBM%':>7s}")
    table = []
    for k, name, by in rows(args.envs):
        ops, cal = m["ops"][k], m["cal_ops"][k]
        sol = min(rf.H100["fp32_issues_per_s"] / ops,
                  rf.H100["hbm_bytes_per_s"] / by)
        line = f"{name:34s} {ops:8.0f} {by:7.1f} {sol:10.4g} "
        row = {"case": k, "ops": ops, "cal_ops": cal, "bytes": by,
               "sol_steps_per_s": sol}
        if rates[k]:
            pct = rf.roofline_pct(rates[k], ops, by, cal)
            row.update(pct, steps_per_s=rates[k])
            line += (f"{rates[k]:10.4g} {pct['fp32_pct']:7.2f} "
                     f"{pct['fp32_cal_pct']:7.2f} {pct['hbm_pct']:7.2f}")
        print(line)
        table.append(row)
    return 1 if drift else 0, table


if __name__ == "__main__":
    sys.exit(main()[0])
