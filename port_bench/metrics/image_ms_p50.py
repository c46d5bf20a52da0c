"""Median wall ms, over every request of the window, from the call to its
result on the host."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.latencies_s, 50) * 1e3) if ctx.latencies_s else None
