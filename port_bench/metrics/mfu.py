"""The model FLOPs of the traced window's requests (``flops.py``: the
detector on every tile and on the standard pass, the enhancer on the
image's own pixels), over the host seconds that the same requests took when
run untraced just before the window, as a share of the card's bfloat16
dense peak (``peaks.py``). The profiler's own host cost, which stretches
the traced window, is so left out."""
from port_bench import peaks


def read(ctx):
    if not ctx.plain_s or not ctx.plain_images or not ctx.flops_per_image:
        return None
    return 100.0 * ctx.plain_images * ctx.flops_per_image / ctx.plain_s / peaks.BF16_FLOPS_PER_S
