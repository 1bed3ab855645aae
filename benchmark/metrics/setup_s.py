"""setup_s: process start to the end of the warm-up calls (host clock):
imports, the kernels' build or load, the env, the trainer's state, the
weights and two calls of the entry."""


def read(ctx):
    return ctx.setup_s
