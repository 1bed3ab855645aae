"""device_idle_pct: the share of the traced window in which no operation
ran on the device: 1 - (union of the trace's device intervals) / window.
"""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
