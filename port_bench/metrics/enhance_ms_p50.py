"""Median of the program's ``durations_in_seconds["enhance"]`` (the
enhancer's forward, closed by a synchronise) over the traced window's
requests, in ms."""
import numpy as np


def read(ctx):
    values = [d["enhance"] for d in ctx.durations if "enhance" in d]
    return float(np.median(values) * 1e3) if values else None
