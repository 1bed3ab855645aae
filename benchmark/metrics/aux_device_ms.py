"""aux_device_ms: device time per call of every operation other than
K5 (the draws' RNG and stacking, the episode accounting, the trajectory
copies), from the traced segment's trace; the trace may drop launches
(the run prints recorded against made)."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    return 1e3 * (t["device_s"] - t["kernel_s"]) / t["calls"]
