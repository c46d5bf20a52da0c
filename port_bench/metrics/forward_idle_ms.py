"""Device-idle ms per image inside the program's ``forward.tiles`` and
``forward.full`` spans (the detector's forward over the tile batch, and the
standard pass with its letterbox; each with its decode and top-k), their
``nms`` children left out (those count in ``merge_idle_ms``), with the
spans placed on the traced window's device clock (``port_bench/spans.py``).
Reads the program's spans through ``facedet_tpu_torch.utils.profiling``;
nothing where the program records none or the clocks do not pair within
50 us."""
from port_bench import spans


def read(ctx):
    return spans.idle_ms_per_image(ctx, inside=("forward.tiles", "forward.full"), leave_out=("nms",))
