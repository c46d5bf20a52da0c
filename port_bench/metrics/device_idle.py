"""Share of the traced window (host seconds from the first request's call
to the last result) in which no device operation ran, from the union of the
profiler's device intervals."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
