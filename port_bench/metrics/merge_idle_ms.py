"""Device-idle ms per image inside the program's ``nms`` spans (every
``ops/nms.greedy_keep_mask`` call: the per-tile NMS of both forwards and the
GreedyNMM merge, read-backs included) and its ``merge`` spans (``_pipeline``'s
concatenation, merge, clip and truncation), with the spans placed on the
traced window's device clock (``port_bench/spans.py``). Reads the program's
spans through ``facedet_tpu_torch.utils.profiling``; nothing where the
program records none or the clocks do not pair within 50 us."""
from port_bench import spans


def read(ctx):
    return spans.idle_ms_per_image(ctx, inside=("nms", "merge"))
