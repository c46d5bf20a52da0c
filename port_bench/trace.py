"""The traced window: a ``torch.profiler`` record of the card's activity over
a run of requests, guarded against lost records, reduced to device
intervals.

The guard is a frozen copy of the one in the program's
``utils/profiling.profile_kernels``: late in a process the profiler has
been seen to lose the first records of a window and to deliver its last
ones late. So the window is opened after an empty one that takes such late
records, the requests run between 64 marker kernels (``torch.cuda._sleep``)
and 20,000 after them, and a window counts only when at least one marker
came before the requests' first record and one after their last, and none
is extra. Otherwise it is taken again, the requests run anew, at most three
times. The long trailing run pushes the requests' last records out of the
profiler's last buffer: on the H100, windows of 60 single-image requests
lost all 64 trailing markers in two of four tries, and kept at least
14,231 of 20,000 in four of four.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

PAD = 64
PAD_AFTER = 20_000
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
TRIES = 3
# CUDA runtime calls after which the host had to wait for the device
_SYNC = ("Synchronize", "Memcpy", "EventQuery")


@dataclasses.dataclass
class Trace:
    """Device records of one traced window, times in seconds from its start."""

    ops: list  # (name, start, end) of every device record but the markers
    runtime: list  # (name, start, end) of the CUDA runtime calls on the host
    window_s: float  # host seconds from the first request's call to the last result

    @property
    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        busy, end = 0.0, float("-inf")
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def seconds_by_name(self, match: str) -> float:
        return sum(e - s for name, s, e in self.ops if match in name.lower())

    def count(self, match: str | None = None) -> int:
        return sum(1 for name, _, _ in self.ops if match is None or match in name.lower())

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle time
        between device operations by the last CUDA runtime call the host
        returned from before each gap (``host work after <call>``)."""
        by_op: dict[str, float] = {}
        for name, s, e in self.ops:
            by_op[name] = by_op.get(name, 0.0) + (e - s)
        ends = sorted((e, name) for name, _, e in self.runtime)
        end_times = [e for e, _ in ends]
        gaps: dict[str, float] = {}
        last = None
        for name, s, e in sorted(self.ops, key=lambda o: o[1]):
            if last is not None and s > last:
                i = bisect.bisect_right(end_times, last) - 1
                call = ends[i][1] if i >= 0 else "the window's start"
                kind = "a read-back wait" if any(k in call for k in _SYNC) else call
                label = f"host work after {kind}"
                gaps[label] = gaps.get(label, 0.0) + (s - last)
            last = e if last is None else max(last, e)
        order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": order(by_op), "idle_gaps": order(gaps)}


def traced(run, device) -> tuple[Trace, object]:
    """(the ``Trace`` of one call of ``run()``, its return value)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def markers(count):
        for _ in range(count):
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize(device)

    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(TRIES):
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            markers(PAD)
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
            markers(PAD_AFTER)
        events = prof.events()
        device_recs = sorted((e.time_range.start, e.time_range.end, e.name) for e in events if e.device_type == cuda)
        calls = [r for r in device_recs if MARKER not in r[2]]
        first = calls[0][0] if calls else float("inf")
        last = calls[-1][0] if calls else float("-inf")
        before = sum(1 for s, _, n in device_recs if MARKER in n and s < first)
        after = sum(1 for s, _, n in device_recs if MARKER in n and s > last)
        extra = sum(1 for _, _, n in device_recs if MARKER in n) - PAD - PAD_AFTER
        if calls and before and after and extra <= 0:
            t_first = calls[0][0]
            ops = [(n, (s - t_first) / 1e6, (e - t_first) / 1e6) for s, e, n in calls]
            runtime = [(e.name, (e.time_range.start - t_first) / 1e6, (e.time_range.end - t_first) / 1e6)
                       for e in events if e.device_type != cuda and e.name.startswith("cuda")]
            return Trace(ops, runtime, window_s), out
        print(f"port_bench trace: window {attempt + 1} lost records ({before} markers before the requests, "
              f"{after} after, {extra} extra); taking another", flush=True)
    raise RuntimeError(f"no whole profiler window in {TRIES} tries")
