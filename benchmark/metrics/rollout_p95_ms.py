"""rollout_p95_ms: the 95th percentile (nearest rank) of the latency of
every call in the window, from the call to the end of its synchronize
(host clock): the rollout phase every PPO iteration waits for."""

from benchmark import stats


def read(ctx):
    return 1e3 * stats.percentile(ctx.latencies_s, 95)
