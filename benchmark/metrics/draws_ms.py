"""draws_ms: the host's time in the draws a rollout, the ``rollout.draws``
spans (``RowRaceEnv.stacked_draws``: the K steps' ``_sample_draws`` and
their stacking; at a deterministic config the cached block) summed over
each traced rollout, mean over the traced segment's rollouts (host
clock, the program's spans)."""

from benchmark.spans import read_with


def read(ctx):
    return read_with(ctx, lambda seg: seg.total_ms("rollout.draws"))
