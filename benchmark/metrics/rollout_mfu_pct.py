"""rollout_mfu_pct: the whole rollout's share of the card's FP32 issue
rate: the frozen counted work of an env-step (the env step of every
drone and, in policy mode, the policy's forward and sample for each) x
the window's env-steps per second, over the peak (``peaks.json``). It
bounds every kernel's share: work moved off K5 still counts here."""


def read(ctx):
    p = ctx.peaks
    if p is None or not ctx.counts:
        return None
    rate = ctx.units_per_call * ctx.calls / ctx.window_s
    return 100.0 * ctx.counts["ops_per_env_step"] * rate / \
        p["fp32_issues_per_s"]
