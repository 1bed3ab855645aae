"""env_steps_per_s: env-steps completed per second of the window.

One env-step advances every drone of one env by one control step; a call
completes n_envs x n_steps of them. The rate is over all the calls and
all the time of the window, from its start to the synchronize of its
last call (host clock)."""

from benchmark import stats


def read(ctx):
    return stats.rate(ctx.units_per_call * ctx.calls, ctx.window_s)
