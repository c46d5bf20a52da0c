"""The reader ``epilogue_kernel_share`` on a synthetic ring of spans made with
the program's own recorder: an untraced pass of requests before a traced
window, each request's two ``detector`` spans counting the BatchNorm
epilogues of their forwards."""
import pytest

from facedet_tpu_torch.utils import profiling
from port_bench import harness, spans

METRIC = "epilogue_kernel_share.latency"


def _ring(plain, traced):
    """One request per entry of ``plain`` (untraced) and then of ``traced``
    (under the profiler), each a ``request`` root over one ``forward.tiles``
    and one ``forward.full`` span, each forward over a ``detector`` span
    counting the counters given for that request ({counter: n} per forward,
    or None: no counter)."""
    rec = profiling.SpanRecorder()
    t = 1_000_000_000
    for profiled, requests in ((False, plain), (True, traced)):
        for counts in requests:
            rid = rec.new_request()
            root = profiling.Span(rec, "request", rid)
            root.profiled, root.start_ns = profiled, t
            closed = []
            for k, forward in enumerate(("forward.tiles", "forward.full")):
                fwd = profiling.Span(rec, forward, rid)
                det = profiling.Span(rec, "detector", rid)
                fwd.parent, det.parent = root, fwd
                fwd.start_ns, det.start_ns = t + 10 * k + 1, t + 10 * k + 2
                det.end_ns, fwd.end_ns = t + 10 * k + 5, t + 10 * k + 9
                det.counts = None if counts is None else dict(counts[k], graph_replays=1)
                closed += [det, fwd]
            root.end_ns = t + 30
            rec.ring.extend(closed + [root])
            t += 100
    return rec


def _ctx(n):
    ctx = harness.Context(harness.Cell("synthetic", {"trace_requests": n}, {}, {}, [], []))
    ctx.plain_images = ctx.images = n
    return ctx


KERNEL = {"epilogue_kernel": 87}
MIXED = {"epilogue_kernel": 20, "epilogue_plain": 67}  # an int8 detector: its Int8ConvBnAct through PyTorch ops
PLAIN = {"epilogue_plain": 87}


@pytest.mark.parametrize("plain,want", [
    ([(KERNEL, KERNEL)] * 3, 100.0),
    ([(KERNEL, PLAIN), (PLAIN, KERNEL), (KERNEL, PLAIN)], 50.0),
    ([(MIXED, MIXED)] * 3, 100.0 * 20 / 87),
    ([(PLAIN, PLAIN)] * 3, 0.0),
])
def test_the_share_reads_the_untraced_requests(monkeypatch, plain, want):
    # the traced window counts otherwise, and is not read
    rec = _ring([(PLAIN, PLAIN)] + plain, [(PLAIN, KERNEL)] * 3)
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    assert harness.reader(METRIC)(_ctx(3)) == pytest.approx(want)


def test_a_program_that_counts_no_epilogue_gives_nothing(monkeypatch):
    """The parent's program: spans, but neither counter."""
    rec = _ring([None] * 3, [None] * 3)
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    assert harness.reader(METRIC)(_ctx(3)) is None
    monkeypatch.setattr(spans, "recorder", lambda: None)
    assert harness.reader(METRIC)(_ctx(3)) is None


def test_too_few_untraced_requests_give_nothing(monkeypatch):
    rec = _ring([(KERNEL, KERNEL)] * 2, [(KERNEL, KERNEL)] * 3)
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    assert harness.reader(METRIC)(_ctx(3)) is None
