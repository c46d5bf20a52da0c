"""The tile gather's least time (``bytes.py``: the windows' union read once
and the tiles written once, at the card's HBM bandwidth, ``peaks.py``) over
the device time of the gather kernels (``tile_gather`` in the name) in the
traced window. Nothing when no gather kernel ran."""
from port_bench import peaks


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    seconds = t.seconds_by_name("tile_gather")
    if seconds <= 0 or not ctx.images:
        return None
    return 100.0 * ctx.images * ctx.gather_bytes_per_image / peaks.HBM_BYTES_PER_S / seconds
