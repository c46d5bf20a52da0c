"""What a driver hands back from a run of requests, and the closed loop of
one client that the single-request drivers share."""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Window:
    answers: list  # (photo index, numpy answer or None when it failed)
    attempted: int  # answers due
    failed: int  # missing, raised, non-finite or outside the image
    t_open: float = 0.0  # perf_counter at the window's start
    window_s: float = 0.0
    images: int = 0  # images answered inside the window
    latencies_s: list = dataclasses.field(default_factory=list)
    durations: list = dataclasses.field(default_factory=list)
    enhanced: dict = dataclasses.field(default_factory=dict)  # photo index -> a served enhanced image
    error: str = ""  # the first exception a request raised


class ClosedLoop:
    """One client: the next request is sent when the last one's result is on
    the host. A driver defines ``_one(k, win)``, which sends request ``k``,
    records its answer into ``win`` and returns the time its result came."""

    def requests(self, count: int) -> Window:
        win = Window(answers=[], attempted=0, failed=0)
        for k in range(count):
            self._one(k, win)
        win.images = count
        return win

    def window(self, seconds: float) -> Window:
        win = Window(answers=[], attempted=0, failed=0)
        win.t_open = t = time.perf_counter()
        k = 0
        while t - win.t_open < seconds:
            t = self._one(k, win)
            k += 1
        win.window_s, win.images = t - win.t_open, k
        return win
