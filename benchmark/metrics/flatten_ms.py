"""flatten_ms: the host's time building the flat ``Transition``, the
finished episodes' metrics and the trainer's new state a rollout, the
``rollout.flatten`` span, mean over the traced segment's rollouts (host
clock, the program's spans)."""

from benchmark.spans import read_with


def read(ctx):
    return read_with(ctx, lambda seg: seg.total_ms("rollout.flatten"))
