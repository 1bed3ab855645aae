"""rollout_other_ms: the root span ``rollout``'s own time a rollout, less
its child spans (draws, launches, accounting, flattening): the Gaussian
draws' enqueue, ``pack_policy_params``, the row conversions and the chunk
loop; mean over the traced segment's rollouts (host clock, the program's
spans)."""

from benchmark.spans import read_with


def read(ctx):
    return read_with(ctx, lambda seg: seg.self_ms())
