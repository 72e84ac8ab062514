"""Seconds from the process's start to the first timed call: imports,
the kernels' build or load, the inputs, the warm-up."""


def read(ctx):
    return ctx.setup_s
