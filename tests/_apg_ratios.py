"""apg's best-over-first loss ratio, the JAX package's against the port's.

Runs ``examples/apg.py``'s ``run(iters, horizon, n_envs, lr, seed)`` and
the port's ``gym_pybullet_adrp_tpu_torch.examples.apg.run`` on the CPU for
each seed and prints one JSON line a run: ``min(losses) / losses[0]``.
The two draw their start offsets from different generators, so a seed
gives each its own starts; the spread over seeds is what a bar on the
ratio has to sit inside.

    python tests/_apg_ratios.py --seeds 0 1 2 3 4 --n_envs 256
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--n_envs", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--which", choices=["jax", "torch", "both"],
                    default="both")
    args = ap.parse_args()

    runs = []
    if args.which in ("jax", "both"):
        from examples import apg as japg
        runs.append(("jax", lambda s: japg.run(args.iters, args.horizon,
                                               args.n_envs, args.lr, s)))
    if args.which in ("torch", "both"):
        from gym_pybullet_adrp_tpu_torch.examples import apg as tapg
        runs.append(("torch", lambda s: tapg.run(
            args.iters, args.horizon, args.n_envs, args.lr, s,
            device="cpu", verbose=False)))
    for name, run in runs:
        for seed in args.seeds:
            t0 = time.time()
            losses, dist = run(seed)
            print(json.dumps({
                "impl": name, "seed": seed, "n_envs": args.n_envs,
                "lr": args.lr, "first": losses[0], "best": min(losses),
                "ratio": min(losses) / losses[0], "dist": dist,
                "s": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
