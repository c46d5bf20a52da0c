"""Median over the window's requests, run untraced just before the traced
window (``run.py``), of the host's own ms in each: its root spans' length
less its spans where the host waits for the device (``readback`` in the NMS
fixpoint, ``fetch_wait`` for the result, ``enhance`` with its
synchronise). That is plan, staging, upload, launches and the host's
post-processing, without the profiler's stretch of the host. Reads the
program's spans through ``facedet_tpu_torch.utils.profiling``
(``port_bench/spans.py``); nothing where the program records none."""
import statistics

from port_bench import spans


def read(ctx):
    requests = spans.window(ctx, profiled=False)
    if requests is None:
        return None
    return statistics.median(spans.host_ms(requests))
