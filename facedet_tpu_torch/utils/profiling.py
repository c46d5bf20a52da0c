"""Profiling and performance measurement (counterpart of
facedet_tpu/utils/profiling.py).

The same tools over torch: the ``durations_in_seconds`` phase timer,
FLOPs and parameters of a forward, warmup-then-measure latency, the
device's memory statistics, and a trace of a region.

``flops_and_params`` counts with ``torch.utils.flop_counter.FlopCounterMode``:
torch's count, which is not XLA's cost analysis. It counts the matmuls and
convolutions (two FLOPs per multiply-add) and nothing elementwise, where XLA
counts every operation of the compiled program, so the two packages' numbers
for one model differ.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch

__all__ = [
    "Stopwatch",
    "flops_and_params",
    "measure_latency",
    "device_memory_stats",
    "trace",
]


class Stopwatch:
    """Accumulating phase timer producing a durations_in_seconds dict."""

    def __init__(self):
        self.durations: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.durations[name] = self.durations.get(name, 0.0) + (
                time.perf_counter() - t0
            )


def flops_and_params(fn: Callable, *example_args, params=None) -> dict:
    """FLOPs of ``fn(*example_args)`` by torch's flop counter (module
    docstring) and the parameter count of ``params`` (an ``nn.Module``, a
    dict or an iterable of tensors; None gives None)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*example_args)
    flops = float(counter.get_total_flops())
    if params is None:
        n_params = None
    else:
        if isinstance(params, torch.nn.Module):
            params = params.parameters()
        elif isinstance(params, dict):
            params = params.values()
        n_params = sum(int(np.prod(p.shape)) for p in params)
    return {"flops": flops, "gflops": flops / 1e9, "params": n_params}


def _block(_out) -> None:
    """Wait for the device work behind ``fn``'s result (the card's, where
    this process uses it)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure_latency(fn: Callable, *args, warmup: int = 3, iters: int = 10) -> dict:
    """Warmup-then-measure latency and FPS; each call is waited for
    (``torch.cuda.synchronize`` where the card is in use)."""
    for _ in range(warmup):
        _block(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "mean_ms": 1000 * float(np.mean(times)),
        "p50_ms": 1000 * times[len(times) // 2],
        "min_ms": 1000 * times[0],
        "fps": 1.0 / float(np.mean(times)),
    }


def device_memory_stats(device=None) -> dict:
    """The device's memory statistics (``torch.cuda.memory_stats``), under
    the JAX module's keys; {} for a CPU device or where there is no card."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` over the region (the card's kernels too where it
    is in use), written as a Chrome trace ``trace.json`` into ``log_dir``
    (default: ``torch-trace`` in the temporary directory); yields the
    directory."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
