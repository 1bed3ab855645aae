"""host_copies_per_rollout: the synchronizing copies of host values to
the card a rollout, the counter ``host_copies`` (one a
``RowRaceEnv._host_copy``) summed over each traced rollout's spans, mean
over the traced segment's rollouts (the program's counter)."""

from benchmark.spans import read_with


def read(ctx):
    return read_with(ctx, lambda seg: seg.count("host_copies"))
