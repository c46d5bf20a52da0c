"""Device ns per bilinear sample of the decoder's deformable attention: the
device time of the sampling kernels in the traced window over the samples
that the window's requests took, the sum of the program's ``deform_samples``
counter of their ``detector`` spans (``engine/rtdetr_wrapper``: tiles x
queries x heads x levels x points x layers, from shapes on the host), read
through ``facedet_tpu_torch.utils.profiling`` (``port_bench/spans.py``).
The sampling kernels, found by name (any case): ``grid_sampler``, the
kernel of ``torch.nn.functional.grid_sample`` (``grid_sampler_2d_kernel``).
Nothing where either part is missing."""
from port_bench import spans

KERNELS = ("grid_sampler",)


def read(ctx):
    if ctx.trace is None:
        return None
    requests = spans.window(ctx, profiled=True)
    if requests is None:
        return None
    samples = spans.counter(requests, "deform_samples")
    seconds = sum(ctx.trace.seconds_by_name(k) for k in KERNELS)
    if samples <= 0 or seconds <= 0:
        return None
    return 1e9 * seconds / samples
