"""NMS and merge fixpoint rounds per image: the program's ``nms_rounds``
counter (``ops/nms.greedy_keep_mask``, one per round, each round one
blocking read-back of its flag) summed over the window's requests run
untraced just before the traced window (``run.py``), over the images they
answered. Reads the program's spans through
``facedet_tpu_torch.utils.profiling`` (``port_bench/spans.py``); nothing
where the program records none."""
from port_bench import spans


def read(ctx):
    requests = spans.window(ctx, profiled=False)
    if requests is None or not ctx.plain_images:
        return None
    return spans.counter(requests, "nms_rounds") / ctx.plain_images
