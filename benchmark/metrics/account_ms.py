"""account_ms: the host's time in the episode accounting a rollout, the
``rollout.account`` spans (each chunk's pre-step obs ``cat`` and its
``_ep_account`` calls), mean over the traced segment's rollouts (host
clock, the program's spans)."""

from benchmark.spans import read_with


def read(ctx):
    return read_with(ctx, lambda seg: seg.total_ms("rollout.account"))
