"""Entry ``engine/pipelines.enhance_first_pipeline`` with its defaults (the
``fixed_grid`` slice policy, the enhancer's own tiling): one client in a
closed loop, one uint8 photo per request in the mix's order. Every
request's detections are judged; of the enhanced images, one occurrence per
photo is kept for the pixel comparison: the one drawn from the seed, or the
last one served where the window closed before it."""
from __future__ import annotations

import time

import numpy as np

from port_bench import check, program
from port_bench.window import ClosedLoop, Window


class Driver(ClosedLoop):
    def __init__(self, cell, device, int8: bool = False, enhancer=None):
        """``enhancer`` replaces the program's (the check's control puts the
        reference there)."""
        self.cell, self.device = cell, device
        self.model = program.detector(cell.config, device, int8)
        self.enhancer = enhancer or program.enhancer(cell.config, device)

    def load(self, items: list, seed: int) -> None:
        self.items = [it["rgb"] for it in items]
        self.keep = np.random.default_rng([int(seed) % (1 << 64), 7]).integers(0, 3, len(items))

    def warm(self) -> None:
        self.requests(2)

    def _one(self, k: int, win: Window) -> float:
        from facedet_tpu_torch.engine.pipelines import enhance_first_pipeline

        n = len(self.items)
        p = k % n
        t0 = time.perf_counter()
        try:
            out = enhance_first_pipeline(self.items[p], self.model, self.enhancer)
            det = program.detections(out.detections)
            t1 = time.perf_counter()
            h, w = self.items[p].shape[:2]
            ok = check.sound(det, h, w)
            if ok and k // n <= self.keep[p]:
                win.enhanced[p] = np.asarray(out.enhanced_image)
            win.durations.append(dict(out.durations_in_seconds))
        except Exception as exc:  # the request failed; the run goes on
            t1, det, ok = time.perf_counter(), None, False
            win.error = win.error or f"{type(exc).__name__}: {exc}"
        win.answers.append((p, det if ok else None))
        win.attempted += 1
        win.failed += not ok
        win.latencies_s.append(t1 - t0)
        return t1
