"""Entry ``get_sliced_prediction``: one client in a closed loop, one photo
per request in the mix's order, the result on the host before the next
call. Latency is the call's wall time."""
from __future__ import annotations

import time

from port_bench import check, program
from port_bench.window import ClosedLoop, Window


class Driver(ClosedLoop):
    def __init__(self, cell, device, int8: bool = False):
        self.cell, self.device = cell, device
        self.model = program.detector(cell.config, device, int8)
        self.kw = program.sliced_kwargs(cell.config, cell.mix, cell.spec["entry"])

    def load(self, items: list, seed: int) -> None:
        self.items = [program.program_input(it) for it in items]

    def warm(self) -> None:
        self.requests(3)

    def _one(self, k: int, win: Window) -> float:
        from facedet_tpu_torch import get_sliced_prediction

        p = k % len(self.items)
        t0 = time.perf_counter()
        try:
            res = get_sliced_prediction(self.items[p], self.model, **self.kw)
            det = program.detections(res.detections)
            t1 = time.perf_counter()
            ok = check.sound(det, self.cell.mix["height"], self.cell.mix["width"])
        except Exception as exc:  # the request failed; the run goes on
            t1, det, ok = time.perf_counter(), None, False
            win.error = win.error or f"{type(exc).__name__}: {exc}"
        win.answers.append((p, det if ok else None))
        win.attempted += 1
        win.failed += not ok
        win.latencies_s.append(t1 - t0)
        return t1
