"""draws_blocked_ms: the host's time in the draws' copies of host values
to the card a rollout, the ``draws.host_copies`` spans
(``RowRaceEnv._host_copy``): from pageable memory each copy waits for the
stream to drain, so this is mostly the host waiting on the card; mean
over the traced segment's rollouts (host clock, the program's spans)."""

from benchmark.spans import read_with


def read(ctx):
    return read_with(ctx, lambda seg: seg.total_ms("draws.host_copies"))
