"""Entry ``predict_stream_batched``: a closed, always-full stream that cycles
the mix's photos, batches of ``batch_size`` with ``window`` in flight, raw
results on the host. The measured window opens at the arrival of batch
``OPEN_AT`` (so the staging ring and the pipeline are full) and closes at
the first arrival ``seconds`` after it; the stream then stops taking photos
at a batch boundary and drains. Each batch's results are copied out as
numpy when they arrive and the program's tensors dropped, as a service
hands them on. Every answer, in the window or not, is judged."""
from __future__ import annotations

import time

from port_bench import check, program
from port_bench.window import Window

OPEN_AT = 5


class Driver:
    def __init__(self, cell, device, int8: bool = False):
        self.cell, self.device = cell, device
        self.entry = cell.spec["entry"]
        self.model = program.detector(cell.config, device, int8)
        self.kw = program.sliced_kwargs(cell.config, cell.mix, self.entry)

    def load(self, items: list, seed: int) -> None:
        self.items = [program.program_input(it) for it in items]

    def warm(self) -> None:
        self.requests(2 * self.entry["batch_size"])

    def _run(self, stop, keep_going):
        """(results [(first image, numpy answers, arrival)], images pulled, error)."""
        from facedet_tpu_torch import predict_stream_batched

        b, n = self.entry["batch_size"], len(self.items)
        pulled = [0]

        def source():
            i = 0
            while not (i % b == 0 and stop(i)):
                yield self.items[i % n]
                i += 1
                pulled[0] = i

        results, error = [], ""
        stream = predict_stream_batched(source(), self.model, batch_size=b, window=self.entry["window"], raw=True,
                                        **self.kw)
        try:
            for k, raw in enumerate(stream):
                answers = program.batch_detections(raw)
                results.append((k * b, answers, time.perf_counter()))
                keep_going(k, results[-1][2])
        except Exception as exc:  # a failed batch fails every image still due
            error = f"{type(exc).__name__}: {exc}"
        return results, pulled[0], error

    def _answers(self, results, pulled, error) -> Window:
        h, w = self.cell.mix["height"], self.cell.mix["width"]
        n, answers, failed = len(self.items), [], 0
        for first, dets, _ in results:
            for i, det in enumerate(dets):
                ok = check.sound(det, h, w)
                answers.append(((first + i) % n, det if ok else None))
                failed += not ok
        failed += pulled - len(answers)
        return Window(answers=answers, attempted=pulled, failed=failed, error=error)

    def requests(self, count: int) -> Window:
        """One whole stream over ``count`` images (a multiple of the batch)."""
        results, pulled, error = self._run(lambda i: i >= count, lambda k, t: None)
        win = self._answers(results, pulled, error)
        win.images = len(win.answers)
        return win

    def window(self, seconds: float) -> Window:
        b = self.entry["batch_size"]
        state = {"open": None, "close": None}

        def keep_going(k, t):
            if k == OPEN_AT:
                state["open"] = t
            elif state["open"] is not None and state["close"] is None and t - state["open"] >= seconds:
                state["close"] = t

        results, pulled, error = self._run(lambda i: state["close"] is not None, keep_going)
        win = self._answers(results, pulled, error)
        if state["close"] is None:
            raise RuntimeError(f"the stream ended before its window closed: {error}")
        win.t_open, win.window_s = state["open"], state["close"] - state["open"]
        win.images = b * sum(1 for _, _, t in results if state["open"] < t <= state["close"])
        return win
