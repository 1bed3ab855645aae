"""race_rollout_roofline: K5's least time per launch over its measured
device time per recorded launch (%).

The least time is the larger of the launch's counted operations over the
card's FP32 issue rate and its bytes (each operand read once, each result
written once) over HBM's rate: ``counts.py``, frozen per configuration.
The device time is K5's traced time over the launches the trace
recorded, since the profiler may drop some (both counts are printed)."""

from benchmark.counts import k5_bytes_per_launch


def read(ctx):
    t, p = ctx.trace, ctx.peaks
    if t is None or p is None or not t["kernel_launches"] or not ctx.counts:
        return None
    d, kind = ctx.dims, ctx.traffic["kind"]
    ops = ctx.counts["ops_per_env_step"] * ctx.traffic["n_envs"] * d["K"]
    nbytes = k5_bytes_per_launch(d, kind, d["K"], d["hidden"])
    bound_s = max(ops / p["fp32_issues_per_s"],
                  nbytes / p["hbm_bytes_per_s"])
    per_launch = t["kernel_s"] / t["kernel_launches"]
    ctx.log(f"race_rollout: bound {1e3 * bound_s:.6g} ms a launch "
            f"({ops:.6g} issues, {nbytes:.6g} bytes), traced "
            f"{1e3 * per_launch:.6g} ms over {t['kernel_launches']} "
            f"recorded of {t['launches_made']} launches made")
    return 100.0 * bound_s / per_launch
