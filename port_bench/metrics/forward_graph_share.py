"""Share of the detector's pre-NMS chains (forward, decode, top-k) that
replayed a CUDA graph: the program's counters of its ``detector`` spans
(``engine/detector.ForwardGraphs``, exactly one a call: ``graph_replays``,
``graph_captures`` or ``graph_eager``), summed over the window's requests
run untraced just before the traced window (``run.py``), as
``100 * replays / (replays + captures + eager)``. Reads the program's spans
through ``facedet_tpu_torch.utils.profiling`` (``port_bench/spans.py``);
nothing where the program records none of the three."""
from port_bench import spans

COUNTERS = ("graph_replays", "graph_captures", "graph_eager")


def read(ctx):
    requests = spans.window(ctx, profiled=False)
    if requests is None:
        return None
    replays, captures, eager = (spans.counter(requests, name) for name in COUNTERS)
    calls = replays + captures + eager
    return 100.0 * replays / calls if calls else None
