"""race_rollout_enqueue_us: the host's time to enqueue one K5 launch,
the mean ``race_rollout.launch`` span (``ops/race_rollout.race_rollout``
on the card: the checks, the argument structs, the output buffers and the
``ctypes`` call to its return) over the traced segment's launches (host
clock, the program's spans); None when no launch was recorded."""

from benchmark.spans import read_with


def _mean_us(seg):
    spans = seg.named("race_rollout.launch")
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / 1e3 / len(spans)


def read(ctx):
    return read_with(ctx, _mean_us)
