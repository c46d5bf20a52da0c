"""95th percentile (linear interpolation) of the same latencies."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.latencies_s, 95) * 1e3) if ctx.latencies_s else None
