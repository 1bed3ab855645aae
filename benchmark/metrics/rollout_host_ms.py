"""rollout_host_ms: the host's time in a call, from the call to its
return and before the synchronize, mean over the window's calls (host
clock, the benchmark's span around the entry): the draws, the launches,
the episode accounting and the flattening as the host enqueues them.
Where it exceeds the device's time per call, the host paces the window.
"""


def read(ctx):
    return 1e3 * sum(ctx.host_s) / len(ctx.host_s)
