"""Seconds from the start of the benchmark's process to the first timed
request: imports, CUDA context, inputs, weights, warm-up."""


def read(ctx):
    return ctx.setup_s
