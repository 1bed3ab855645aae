"""Race-PPO phase profile and roofline table.

Counterpart of scripts/profile_ppo.py: times one PPO iteration of the
row race trainer and its phases (env steps only, rollout, update, the
whole iteration) with the policy outside the env kernel (one race_step
launch a step) or, with ``--fuse_policy``, inside it (race_rollout,
``--kernel_chunk`` steps a launch). The JAX script reads XLA's cost model
(``cost``, :34-45), which has no counterpart here; in its place this
prints, on the card, the device time of one traced iteration by kernel
and by top operation, the device's idle share (one less the union of its
intervals over the wall time), the host's spans (utils/profiling.py: host
and self ms and counts by span) and the device's idle time by the
innermost span the host was in, and, on any device,
the update's operations and its bytes read and written op by op
(``utils.profiling.OpCount``, the eager update's traffic) against the
card's peaks, beside its bound: the larger of those operations at the
float32 peak and the bytes it must move at HBM's rate (the trajectory
read by GAE and once an epoch, the parameters and both Adam moments read
and written once an optimizer update).

    python -m gym_pybullet_adrp_tpu_torch.profile_ppo [--envs 4096] \\
        [--config getting_started] [--fuse_policy] [--device cuda]
"""

import argparse
import time

import torch

from .envs import race as race_mod
from .models.policy import sample_action
from .ops import race_rollout as race_rollout_ops
from .ops import race_step as race_step_ops
from .rl.ppo import PPOConfig, make_ppo_core, policy_rollout
from .train_race import _row_adapter
from .utils.config import load_config
from .utils.enums import Physics, RaceMode
from .utils.profiling import (
    PEAK_BYTES, PEAK_FP32_OPS, OpCount, idle_by_span, kernel_time, nbytes,
    ops_ms, span_table, traced,
)

KERNELS = (("race_step", "race_step_kernel"),
           ("race_rollout", "race_rollout_kernel"))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, device, repeats=8, rounds=3):
    """Best over ``rounds`` of the mean seconds of ``repeats`` calls
    queued back to back (one warm-up call first)."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / repeats)
    return best


def launches():
    return {"race_step": race_step_ops.race_step_fused.launches,
            "race_rollout": race_rollout_ops.race_rollout.launches}


def main(argv=None, device="cuda"):
    """Print the profile; returns it as a dict (phase seconds, kernel
    launches per call of each phase, the traced iteration, the update's
    counts)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--n_steps", type=int, default=64)
    ap.add_argument("--config", default="getting_started")
    ap.add_argument("--shuffle_block", type=int, default=512)
    ap.add_argument("--grad_accum", type=int, default=1,
                    help="minibatches accumulated per optimizer update "
                         "(1 = exact SB3 schedule)")
    ap.add_argument("--kernel_chunk", type=int, default=16,
                    help="with --fuse_policy: env steps per rollout-kernel "
                         "launch (0 = one launch per step)")
    ap.add_argument("--fuse_policy", action="store_true",
                    help="profile the policy-in-kernel rollout "
                         "(race_rl_rowfast.make_policy_rollout)")
    ap.add_argument("--repeats", type=int, default=8,
                    help="calls per timing round")
    ap.add_argument("--rounds", type=int, default=3,
                    help="timing rounds (the best is kept)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    B, T = args.envs, args.n_steps
    config = load_config(args.config)
    spec = race_mod.RaceSpec.from_config(config, 1, RaceMode.COMPARE,
                                         Physics.PYB)
    track = race_mod.track_from_config(config, 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    env, adapter, override = _row_adapter(
        spec, track, B, T, device, gen, 0, 1.0, (64, 64), args.fuse_policy,
        args.kernel_chunk)
    blk = max(1, args.shuffle_block)
    while (B * T // 8) % blk:   # train_race's rule: blocks fit a minibatch
        blk //= 2
    cfg = PPOConfig(n_envs=B, n_steps=T, shuffle_block=blk,
                    grad_accum=args.grad_accum)
    init_fn, train_step, _ = make_ppo_core(cfg, adapter,
                                           rollout_override=override,
                                           device=device)
    state = {"ts": init_fn(args.seed)}
    act_gen = torch.Generator(device=device)
    act_gen.manual_seed(args.seed + 1)

    # ---- phase functions ------------------------------------------------
    st0 = env.reset()

    def env_only():
        st = st0
        for _ in range(T):
            a = torch.rand((B, 4), generator=act_gen, device=device) * 2 - 1
            st = env.step(st, a)[0]

    def rollout_only():
        ts = state["ts"]
        if override is not None:
            return override(ts)
        return policy_rollout(T, adapter.step, ts,
                              lambda m, ls: sample_action(m, ls, ts.rng))

    def train(times=None):
        state["ts"], m = train_step(state["ts"], times)
        return m

    out = {"phases": {}, "launches": {}}
    for name, fn in (("env steps only", env_only),
                     ("rollout (env+policy)", rollout_only),
                     ("full train iteration", train)):
        before = launches()
        t = timeit(fn, device, args.repeats, args.rounds)
        n_calls = args.repeats * args.rounds + 1
        out["phases"][name] = t
        out["launches"][name] = {k: (v - before[k]) / n_calls
                                 for k, v in launches().items()}
    t_train = out["phases"]["full train iteration"]
    # the update (GAE and the minibatch epochs) timed inside iterations
    # of its own, the best of ``rounds``: the iteration's time less its own
    # rollout's, where two phases timed apart may differ by more than it
    splits = []
    for _ in range(args.rounds):
        times = {}
        train(times)
        splits.append(times["gae"] + times["update"])
    t_update = min(splits)
    out["phases"]["update (train - rollout)"] = t_update

    print(f"config={args.config} envs={B} n_steps={T} shuffle_block={blk} "
          f"fuse_policy={args.fuse_policy} device={device}")
    print(f"{'phase':<26}{'ms/iter':>10}{'share':>8}   kernel launches "
          f"per call")
    for name in ("env steps only", "rollout (env+policy)",
                 "update (train - rollout)", "full train iteration"):
        t = out["phases"][name]
        la = out["launches"].get(name, {})
        la_s = ", ".join(f"{k} {v:g}" for k, v in la.items() if v)
        print(f"{name:<26}{t * 1e3:>10.2f}{t / t_train:>8.1%}   {la_s}")
    steps = cfg.batch_size
    out["env_steps_per_sec"] = steps / t_train
    print(f"\nenv-steps/s end-to-end : {steps / t_train:,.0f}")

    # ---- one traced iteration: device time by kernel and top op, the
    # host's spans, and the device's idle time by span ------------------
    if device.type == "cuda":
        tr = traced(train)
        wall, busy = tr.wall_ms, tr.busy_ms()
        kern = {k: kernel_time(tr.events, sym) for k, sym in KERNELS}
        top = sorted(tr.events, key=lambda e: -e[2])[:8]
        idle = {k: us / 1e3 for k, us in idle_by_span(tr.trace).items()}
        spans = span_table(tr.spans)
        out["trace"] = {"wall_ms": wall, "busy_ms": busy,
                        "idle_share": 1.0 - busy / wall,
                        "kernels": kern,
                        "top": [(k, c, us / 1e3) for k, c, us in top],
                        "spans": spans, "idle_by_span_ms": idle}
        print(f"\none traced iteration: wall {wall:.4g} ms, device busy "
              f"{busy:.4g} ms (the union of its intervals), idle share "
              f"{out['trace']['idle_share']:.3f}")
        for k, (n, ms) in kern.items():
            if n:
                print(f"  {k}: {n} launches, {ms:.4g} ms on the device "
                      f"({ms / n:.4g} ms a launch)")
        for k, c, ms in out["trace"]["top"]:
            print(f"  {k[:60]:<60} x{c:<5} {ms:9.4g} ms")
        print(f"\nspans (host ms):\n  {'span':<22}{'n':>6}{'ms':>11}"
              f"{'self ms':>11}   counts")
        for name, row in spans.items():
            cnt = ", ".join(f"{k} {v}" for k, v in row["counts"].items())
            print(f"  {name:<22}{row['n']:>6}{row['ms']:>11.4g}"
                  f"{row['self_ms']:>11.4g}   {cnt}")
        print("\nthe device's idle time by the innermost span the host was "
              "in (ms):")
        for name, ms in idle.items():
            print(f"  {name:<28}{ms:>11.4g}")
    else:
        out["trace"] = None
        print("\none traced iteration: not measured (no CUDA device)")

    # ---- the update's operations and bytes ------------------------------
    with OpCount(matmul=True) as c_train:
        train()
    with OpCount(matmul=True) as c_roll:
        _, traj, _ = rollout_only()
    ops = c_train.ops - c_roll.ops
    flops = c_train.flops - c_roll.flops
    traffic = c_train.bytes - c_roll.bytes
    # the least the update must move: GAE reads reward, value and done and
    # writes the advantages and returns; each epoch reads the minibatches'
    # obs, action, logp, advantages and returns once; each optimizer
    # update reads and writes the parameters and both Adam moments once
    n_updates = cfg.n_epochs * (cfg.n_minibatches // cfg.grad_accum)
    floor = (nbytes(traj.reward, traj.value, traj.done) + 2 * nbytes(
        traj.value) + cfg.n_epochs * (nbytes(traj.obs, traj.action,
                                             traj.logp) + 2 * nbytes(
        traj.value)) + n_updates * 6 * nbytes(
        *state["ts"].params.parameters()))
    t_ops = ops_ms(ops, flops)
    t_traffic, t_floor = traffic / PEAK_BYTES * 1e3, floor / PEAK_BYTES * 1e3
    out["update_counts"] = {"ops": ops, "flops": flops, "bytes": traffic,
                            "traffic_ms": t_traffic, "floor_bytes": floor,
                            "bound_ms": max(t_ops, t_floor),
                            "bound_by": ("bytes" if t_floor >= t_ops
                                         else "operations")}
    print(f"\nupdate (GAE and {cfg.n_epochs} x {cfg.n_minibatches} "
          f"minibatches): {ops:.4g} operations counted op by op (float32 "
          f"elementwise and reductions) and {flops:.4g} matrix-product "
          f"flops (2mnk) = {t_ops:.4g} ms at {PEAK_FP32_OPS / 1e12:.4g}e12 "
          f"FP32 issues/s (a flop pair one issue); {traffic:.4g} bytes read "
          f"and written op by op (the eager update's traffic) = "
          f"{t_traffic:.4g} ms at {PEAK_BYTES / 1e12:g} TB/s; bound "
          f"{out['update_counts']['bound_ms']:.4g} ms "
          f"({out['update_counts']['bound_by']}: {floor:.4g} bytes it must "
          f"move); measured {t_update * 1e3:.4g} ms")
    print("\nNOTE: the policy is the reference's 2x64 SB3 MlpPolicy; the "
          "update runs as\nper-minibatch PyTorch ops launched from the "
          "host, far from either peak.")
    return out


if __name__ == "__main__":
    main()
