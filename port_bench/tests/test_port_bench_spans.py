"""The readers of the program's spans (``port_bench/spans.py`` and the
metrics ``nms_rounds``, ``host_work_ms_p50``, ``merge_idle_ms``,
``forward_idle_ms``) on a synthetic trace and a synthetic ring of spans made
with the program's own recorder, whose clock is the trace's plus a planted
offset."""
import subprocess
import sys

import pytest

from facedet_tpu_torch.utils import profiling
from port_bench import harness, spans
from port_bench.trace import Trace

BASE_NS = 7_000_000_000_000  # perf_counter_ns at the first traced request
OFFSET_S = 6999.876543210  # planted: trace seconds = perf_counter_ns / 1e9 - OFFSET_S
REQUEST_MS = 20.0  # a request starts every 20 ms and lasts 10
# (name, parent's name, start ms, end ms, counters[, thread]) within a request
LAYOUT = [
    ("request", None, 0.0, 10.0, None),
    ("plan", "request", 0.0, 0.5, None),
    ("forward.tiles", "request", 1.0, 4.0, None),
    ("nms", "forward.tiles", 3.0, 4.0, {"nms_rounds": 2}),
    ("readback", "nms", 3.5, 4.0, None),
    ("merge", "request", 5.0, 7.0, None),
    ("nms@merge", "merge", 5.5, 7.0, {"nms_rounds": 2}),
    ("readback@merge", "nms@merge", 6.5, 7.0, None),
    ("fetch_wait", "request", 8.0, 9.0, None),
]
# the device's work under the host's launches, as predict_stream_batched
# splits it over three threads: roots that share the batch's id
INNER = [
    ("forward.tiles", None, 2.0, 4.0, None),
    ("nms", "forward.tiles", 3.0, 4.0, {"nms_rounds": 2}),
    ("readback", "nms", 3.5, 4.0, None),
    ("merge", None, 5.0, 7.0, None),
    ("nms@merge", "merge", 5.5, 7.0, {"nms_rounds": 2}),
    ("readback@merge", "nms@merge", 6.5, 7.0, None),
]
STREAM_BATCHED = [
    ("stage", None, 0.0, 1.0, None, 2),
    ("upload", None, 1.0, 1.5, None, 3),
    ("enqueue", None, 1.5, 7.5, None, 3),
    *[(n, p or "enqueue", s, e, c, 3) for n, p, s, e, c in INNER],
    ("fetch_wait", None, 8.0, 9.0, None, 1),
]
# predict_stream: a request root over the dispatch; the result's wait is a
# root of its own that comes later
STREAM = [
    ("request", None, 0.0, 7.5, None),
    ("plan", "request", 0.0, 0.5, None),
    *[(n, p or "request", s, e, c) for n, p, s, e, c in INNER],
    ("fetch_wait", None, 8.0, 9.0, None),
]
# device busy within a request, ms on the trace's clock; the rest is idle:
# forward.tiles self 1.5-2.5; nms self 3.2-3.5 and readback 3.5-3.8;
# merge self 5.2-5.5 and nms 5.5-6.0; fetch_wait 8.5-9.0
BUSY = [(0.0, 1.5), (2.5, 3.2), (3.8, 5.2), (6.0, 8.5), (9.0, 10.0)]
SYNC_LATE_US = [0.3, 0.5, 0.4]  # how far each fetch_wait span ends after its runtime record


def _requests(rec, n, layout, profiled, first_ms, scale=1.0):
    """``n`` requests of ``layout`` into ``rec``'s ring, every ``REQUEST_MS``
    from ``first_ms`` after ``BASE_NS``, with the layout's times times
    ``scale``; each root marked ``profiled``."""
    for k in range(n):
        request = rec.new_request()
        made = {}
        for name, parent, start, end, counts, *thread in layout:
            span = profiling.Span(rec, name.split("@")[0], request)
            span.parent, span.thread, span.counts = made.get(parent), (thread or [1])[0], counts
            if span.parent is None:
                span.profiled = profiled
            t0 = BASE_NS + int((first_ms + k * REQUEST_MS) * 1e6)
            span.start_ns, span.end_ns = t0 + int(scale * start * 1e6), t0 + int(scale * end * 1e6)
            made[name] = span
        for span in sorted(made.values(), key=lambda s: s.end_ns):  # closed innermost first
            rec.ring.append(span)


def _ring(n, layout=LAYOUT, plain=0):
    """``plain`` requests untraced, their host work half as long, then ``n``
    under the profiler."""
    rec = profiling.SpanRecorder()
    _requests(rec, plain, layout, False, -(plain + 1) * REQUEST_MS, scale=0.5)
    _requests(rec, n, layout, True, 0.0)
    return rec


def _trace(n, late_us=SYNC_LATE_US, drop=None):
    t0 = BASE_NS / 1e9 - OFFSET_S
    ops, runtime = [], []
    for k in range(n):
        base = t0 + k * REQUEST_MS / 1e3
        ops += [("kernel", base + s / 1e3, base + e / 1e3) for s, e in BUSY]
        if k != drop:
            end = base + 9.0 / 1e3 - late_us[k % len(late_us)] / 1e6
            runtime.append(("cudaEventSynchronize", end - 1e-5, end))
        runtime.append(("cudaLaunchKernel", base, base + 1e-6))
    first = ops[0][1]
    shift = lambda recs: [(name, s - first, e - first) for name, s, e in recs]  # noqa: E731
    return Trace(shift(ops), shift(runtime), window_s=n * REQUEST_MS / 1e3), first


def _ctx(n, trace, plain_images=0):
    ctx = harness.Context(harness.Cell("synthetic", {"trace_requests": n}, {}, {}, [], []))
    ctx.trace, ctx.images, ctx.plain_images = trace, n, plain_images
    return ctx


@pytest.fixture
def ring(monkeypatch):
    rec = _ring(3, plain=3)
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    return rec


def test_a_planted_clock_offset_is_recovered_within_a_microsecond(ring):
    trace, first = _trace(3)
    requests = spans.window(_ctx(3, trace))
    offset, error = spans.clock(trace, [s for m in requests for s in m])
    # the trace's times start at its first operation
    assert abs(offset - (OFFSET_S + first)) < 1e-6
    assert error < 1e-6


def test_idle_gaps_split_over_the_spans_they_meet(ring):
    trace, _ = _trace(3)
    ctx = _ctx(3, trace)
    assert harness.reader("forward_idle_ms.latency")(ctx) == pytest.approx(1.0, abs=1e-3)
    assert harness.reader("merge_idle_ms.latency")(ctx) == pytest.approx(0.6 + 0.8, abs=1e-3)
    got = spans.report(ctx)
    stages = got["stages_ms"]
    want = {"request/forward.tiles": 1.0, "request/forward.tiles/nms": 0.3,
            "request/forward.tiles/nms/readback": 0.3, "request/merge": 0.3, "request/merge/nms": 0.5,
            "request/fetch_wait": 0.5}
    for path, ms in want.items():
        assert stages[path] == pytest.approx(ms, abs=1e-3), path
    assert got["outside_ms"] == pytest.approx(2 * 10.0 / 3, abs=1e-3)  # the two 10-ms gaps between requests
    # the recovered offset is 0.4 us off the planted one, which leaves slivers that small elsewhere
    assert {k for k, v in stages.items() if v > 0.01} == set(want)
    assert got["share_inside"] == pytest.approx(2.9 / (2.9 + 20.0 / 3), abs=1e-4)
    assert got["clock_error_us"] == pytest.approx(0.1, abs=1e-3)
    assert got["spans_per_request"] == len(LAYOUT)
    assert got["nms_by_site"] == {"forward.tiles": {"rounds_per_call": 2, "calls_per_request": 1.0},
                                  "merge": {"rounds_per_call": 2, "calls_per_request": 1.0}}
    assert got["host_ms_p50"] == pytest.approx({"untraced": 4.0, "traced": 8.0})


def test_the_sweep_splits_a_gap_equally_between_threads():
    a, b = object(), object()
    idle, outside = spans.split_idle([(0.0, 2.0), (3.0, 4.0)], [(0.0, 2.0, a), (1.0, 2.0, b)])
    assert idle[id(a)][1] == pytest.approx(1.5) and idle[id(b)][1] == pytest.approx(0.5)
    assert outside == pytest.approx(1.0)


def test_counters_and_host_work_read_the_untraced_requests(ring):
    trace, _ = _trace(3)
    ctx = _ctx(2, trace, plain_images=2)  # the last two requests of each pass
    assert harness.reader("nms_rounds.latency")(ctx) == 4.0
    # the untraced requests' 5 ms less the two 0.25-ms read-backs and the 0.5-ms fetch wait
    assert harness.reader("host_work_ms_p50.latency")(ctx) == pytest.approx(4.0)
    traced, plain = spans.window(ctx), spans.window(ctx, profiled=False)
    assert [r[0].start_ns for r in traced] == [BASE_NS + int(k * REQUEST_MS * 1e6) for k in (1, 2)]
    assert [r[0].start_ns for r in plain] == [BASE_NS + int(k * REQUEST_MS * 1e6) for k in (-3, -2)]
    assert all(s.profiled for r in traced for s in r if s.parent is None)
    assert not any(s.profiled for r in plain for s in r if s.parent is None)
    # 10 ms less the two 0.5-ms read-backs and the 1-ms fetch wait, under the profiler
    assert spans.host_ms(traced) == pytest.approx([8.0, 8.0])


@pytest.mark.parametrize("layout", ["batched", "single"])
def test_stream_requests_are_read_by_id(monkeypatch, layout):
    """The stream's requests have no root named ``request`` (batched: stage,
    upload, enqueue and fetch_wait roots on three threads; single: the
    result's wait outside the request root); each wait is taken from its own
    root only, so the host's ms are 7.5 less the read-backs' 1.0, in both."""
    rec = _ring(3, STREAM_BATCHED if layout == "batched" else STREAM, plain=3)
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    trace, _ = _trace(3)
    ctx = _ctx(3, trace, plain_images=3)
    assert len(spans.window(ctx)) == len(spans.window(ctx, profiled=False)) == 3
    assert spans.host_ms(spans.window(ctx)) == pytest.approx([6.5] * 3)
    assert harness.reader("host_work_ms_p50.latency")(ctx) == pytest.approx(3.25)
    assert harness.reader("nms_rounds.latency")(ctx) == 4.0
    # forward.tiles self 2.0-3.0 meets the idle 1.5-2.5; nms and merge as in LAYOUT
    assert harness.reader("forward_idle_ms.latency")(ctx) == pytest.approx(0.5, abs=1e-3)
    assert harness.reader("merge_idle_ms.latency")(ctx) == pytest.approx(0.6 + 0.8, abs=1e-3)


@pytest.mark.parametrize("case", ["unpaired", "far", "too_few_requests"])
def test_no_sound_clock_gives_nothing(ring, case):
    if case == "unpaired":
        trace, _ = _trace(3, drop=1)
    elif case == "far":
        trace, _ = _trace(3, late_us=[0.3, 80.0, 0.4])
    else:
        trace, _ = _trace(3)
    ctx = _ctx(4 if case == "too_few_requests" else 3, trace)
    assert harness.reader("merge_idle_ms.latency")(ctx) is None
    assert harness.reader("forward_idle_ms.latency")(ctx) is None
    assert spans.report(ctx)["stages_ms"] is None


def test_a_program_without_spans_gives_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "SPANS")
    trace, _ = _trace(3)
    ctx = _ctx(3, trace)
    for name in ("nms_rounds.latency", "host_work_ms_p50.latency", "merge_idle_ms.latency",
                 "forward_idle_ms.latency"):
        assert harness.reader(name)(ctx) is None, name


def test_the_readers_load_the_program_recorder_and_no_jax():
    code = ("import sys; from port_bench import harness, spans\n"
            "for m in ('nms_rounds', 'host_work_ms_p50', 'merge_idle_ms', 'forward_idle_ms'):\n"
            "    harness.reader(m + '.latency')\n"
            "assert spans.recorder() is not None and 'facedet_tpu_torch.utils.profiling' in sys.modules\n"
            "assert not harness.forbidden_modules(), harness.forbidden_modules()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_the_stages_tool_needs_a_card():
    out = subprocess.run([sys.executable, "port_bench/stages.py", "--workload", "yolo11n.single_rgb", "--seed",
                          "4000000017"], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and "no CUDA device" in out.stderr, out.stderr[-2000:]
