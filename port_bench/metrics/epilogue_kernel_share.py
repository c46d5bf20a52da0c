"""Share of the detector's BatchNorm epilogues (conv, float32 BatchNorm,
cast, activation) that ran through the program's one-pass CUDA kernel
(``ops/kernels/bn_act.py``): the program's counters of its ``detector``
spans, ``epilogue_kernel`` (the kernel) and ``epilogue_plain`` (PyTorch ops,
such as ``Int8ConvBnAct``'s), each counted once a forward and added again by
each replay of a CUDA graph, summed over the window's requests run untraced
just before the traced window (``run.py``), as ``100 * kernel / (kernel +
plain)``. Reads the program's spans through
``facedet_tpu_torch.utils.profiling`` (``port_bench/spans.py``); nothing
where the program records neither counter."""
from port_bench import spans


def read(ctx):
    requests = spans.window(ctx, profiled=False)
    if requests is None:
        return None
    kernel, plain = (spans.counter(requests, name) for name in ("epilogue_kernel", "epilogue_plain"))
    return 100.0 * kernel / (kernel + plain) if kernel + plain else None
