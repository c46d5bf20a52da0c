"""The port's span and counter recorder (utils/profiling.SPANS) and the spans
and counters the engine records with it (engine/predict.py,
engine/pipelines.py, engine/detector.py, ops/nms.py), on the CPU.

The cost budget of a span is about 1.5 us on the card's host with no
profiler, where a bare ``with`` block that reads the clock twice takes about
0.5 us (PERF.md gives both). A CPU test cannot hold an absolute time on a
shared host, so here a span must cost at most three times that bare block,
the two timed in alternating batches.
"""
import ast
import contextlib
import inspect
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from facedet_tpu_torch import YoloV11PoseDetectionModel, get_prediction, get_sliced_prediction
from facedet_tpu_torch.engine import pipelines
from facedet_tpu_torch.engine.predict import predict_stream, predict_stream_batched
from facedet_tpu_torch.ops.nms import greedy_keep_mask
from facedet_tpu_torch.utils import profiling
from facedet_tpu_torch.utils.profiling import SPANS, SpanRecorder
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")
SLICED = dict(slice_height=160, slice_width=160, overlap_height_ratio=0.2, overlap_width_ratio=0.2)
STAGES = ["plan", "stage", "upload", "ingest", "gather", "forward.tiles", "forward.full", "merge", "fetch_wait"]


@pytest.fixture(scope="module")
def model():
    return YoloV11PoseDetectionModel(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.25,
                                     image_size=160, device="cpu")


@pytest.fixture(scope="module")
def image():
    return synthetic_faces(192, 288, seed=0, n=3, size=(30, 60))


def _mark():
    """Empty the ring (earlier tests of this process may have filled it)."""
    SPANS.ring.clear()
    return 0


def _since(mark):
    """The spans closed since ``_mark()``."""
    return SPANS.spans()[mark:]


def _children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.parent is parent]


def test_a_request_nests_its_stages_and_the_fixpoints(model, image):
    mark = _mark()
    get_sliced_prediction(image, model, **SLICED)
    spans = _since(mark)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["request"]
    root = roots[0]
    assert _children(spans, root) == STAGES
    assert all(s.request == root.request and s.thread == root.thread for s in spans)
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in spans)
    by_name = {s.name: s for s in spans if s.parent is root}
    for name in ("forward.tiles", "forward.full", "merge"):
        assert _children(spans, by_name[name]) == ["nms"], name
    for nms in (s for s in spans if s.name == "nms"):
        rounds = nms.counts["nms_rounds"]
        assert rounds >= 1 and _children(spans, nms) == ["readback"] * rounds
        assert set(nms.counts) == {"nms_rounds"}
    assert root.profiled is False and all(s.profiled is None for s in spans if s is not root)


def test_nested_entry_opens_no_second_root(model, image):
    class Enhancer:  # enhance_first_pipeline's view of an enhancer: a x2 upsample
        device, outscale = torch.device("cpu"), 2.0

        def enhance_array(self, x, outscale):
            return torch.nn.functional.interpolate(x.permute(2, 0, 1)[None], scale_factor=2.0)[0].permute(1, 2, 0)

    mark = _mark()
    out = pipelines.enhance_first_pipeline(image, model, Enhancer(), slice_policy="half_image")
    spans = _since(mark)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["request"]
    assert _children(spans, roots[0]) == ["enhance", "request"]
    inner = next(s for s in spans if s.name == "request" and s.parent is roots[0])
    # the enhanced tensor is padded where it lies: no upload
    assert _children(spans, inner) == [s for s in STAGES if s != "upload"]
    assert {s.request for s in spans} == {roots[0].request}
    enhance = next(s for s in spans if s.name == "enhance")
    assert out.durations_in_seconds["enhance"] == enhance.seconds
    assert set(out.durations_in_seconds) == {"slice", "prediction", "postprocess", "enhance"}


def test_stream_spans_share_a_batch_id_across_three_threads(model, image):
    mark = _mark()
    out = list(predict_stream_batched([image] * 4, model, batch_size=2, window=2, raw=True, **SLICED))
    assert len(out) == 2
    spans = _since(mark)
    batches = {}
    for s in spans:
        batches.setdefault(s.request, []).append(s)
    assert len(batches) == 2
    caller = threading.get_ident()
    for members in batches.values():
        top = {s.name: s for s in members if s.parent is None}
        assert set(top) == {"stage", "upload", "enqueue", "fetch_wait"}
        assert top["fetch_wait"].thread == caller
        assert top["upload"].thread == top["enqueue"].thread
        assert len({caller, top["stage"].thread, top["enqueue"].thread}) == 3
        assert _children(members, top["enqueue"]) == ["ingest", "gather", "forward.tiles", "forward.full", "merge"]
        assert top["stage"].end_ns <= top["upload"].end_ns <= top["enqueue"].start_ns


def test_spans_join_requests_by_id_on_any_thread():
    rec = SpanRecorder()
    with rec.span("request") as root:
        with rec.span("child") as child:
            pass
        assert rec.current_request() == root.request
    other = rec.new_request()
    seen = []

    def worker():
        with rec.span("stage", other) as s:
            with rec.span("inner") as inner:
                seen.append((s, inner))

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    (stage, inner), = seen
    assert child.parent is root and child.request == root.request and root.parent is None
    assert stage.request == other != root.request and stage.parent is None
    assert inner.parent is stage and inner.request == other and inner.thread == stage.thread != root.thread
    assert rec.current_request() is None and not rec._stacks


@pytest.mark.parametrize("chain,rounds", [(1, 1), (2, 2), (4, 4)])
def test_nms_rounds_count_each_fixpoint_round(chain, rounds):
    """Rows 0..chain-1, each suppressing the next: Jacobi rounds by hand.
    1 row: nothing changes in round 1. 2 rows: round 1 drops row 1, round 2
    changes nothing. 4 rows: {0}, {0, 2, 3}, {0, 2}, then unchanged."""
    n = 6
    match = torch.zeros(n, n, dtype=torch.bool)
    for i in range(chain - 1):
        match[i, i + 1] = True
    valid = torch.zeros(n, dtype=torch.bool)
    valid[:chain] = True
    mark = _mark()
    kept = greedy_keep_mask(match, valid)
    (nms,) = [s for s in _since(mark) if s.name == "nms"]
    assert nms.counts == {"nms_rounds": rounds}
    assert [s.name for s in _since(mark) if s.parent is nms] == ["readback"] * rounds
    assert kept.tolist() == [i < chain and i % 2 == 0 for i in range(n)]


def test_the_ring_stays_bounded():
    rec = SpanRecorder(capacity=100)
    for i in range(250):
        with rec.span(f"s{i}"):
            pass
    assert len(rec.ring) == 100 and rec.spans()[0].name == "s150" and rec.spans()[-1].name == "s249"


def test_spans_cost_little_without_a_profiler():
    rec = SpanRecorder()

    class Bare:
        def __enter__(self):
            self.t0 = time.perf_counter_ns()
            return self

        def __exit__(self, *exc):
            self.t1 = time.perf_counter_ns()

    span_ns, bare_ns = [], []
    for _ in range(50):  # 100,000 spans in all, each batch beside its control
        t = time.perf_counter_ns()
        with rec.span("request"):
            for _ in range(2_000):
                with rec.span("stage"):
                    pass
        span_ns.append((time.perf_counter_ns() - t) / 2_001)
        t = time.perf_counter_ns()
        for _ in range(2_000):
            with Bare():
                pass
        bare_ns.append((time.perf_counter_ns() - t) / 2_000)
    assert not rec.tracing and len(rec.ring) == rec.ring.maxlen
    assert min(span_ns) <= 3 * min(bare_ns), (min(span_ns), min(bare_ns))


def test_span_code_makes_no_cuda_call(model, image, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span called torch.cuda")

    for name in ("synchronize", "Event", "current_stream", "Stream", "_sleep", "nvtx"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    result = get_sliced_prediction(image, model, **SLICED)
    assert set(result.durations_in_seconds) == {"slice", "prediction", "postprocess"}
    # the recorder's own code names nothing of torch but the profiler's range
    src = "\n".join(inspect.getsource(c) for c in (profiling.Span, profiling.SpanRecorder))
    used = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Attribute):
            parts = []
            while isinstance(node, ast.Attribute):
                parts.append(node.attr)
                node = node.value
            if isinstance(node, ast.Name) and node.id == "torch":
                used.add(".".join(["torch", *reversed(parts)]))
    used = {u for u in used if not any(v.startswith(u + ".") for v in used)}  # whole names only
    assert used == {"torch.autograd.profiler.record_function", "torch.autograd.profiler._is_profiler_enabled"}


def test_durations_come_from_the_spans_on_every_path(model, image):
    mark = _mark()
    got = get_sliced_prediction(image, model, **SLICED)
    spans = _since(mark)
    plan = next(s for s in spans if s.name == "plan")
    wait = next(s for s in spans if s.name == "fetch_wait")
    d = got.durations_in_seconds
    assert set(d) == {"slice", "prediction", "postprocess"} and d["slice"] == plan.seconds
    assert d["prediction"] == (wait.end_ns - plan.end_ns) / 1e9 >= wait.seconds

    mark = _mark()
    streamed = list(predict_stream([image, image], model, window=2, **SLICED))
    spans = _since(mark)
    for r in streamed:
        assert set(r.durations_in_seconds) == {"slice", "prediction"}
    for request in {s.request for s in spans}:
        plan = next(s for s in spans if s.request == request and s.name == "plan")
        wait = next(s for s in spans if s.request == request and s.name == "fetch_wait")
        assert wait.parent is None and wait.start_ns > plan.end_ns  # the result's wait joins its request
        want = (wait.end_ns - plan.end_ns) / 1e9
        assert any(r.durations_in_seconds["prediction"] == want for r in streamed)

    mark = _mark()
    single = get_prediction(image, model)
    spans = _since(mark)
    predict = next(s for s in spans if s.name == "predict")
    assert single.durations_in_seconds == {"prediction": predict.seconds}
    assert _children(spans, predict) == ["inference"]
    assert model.durations_in_seconds["prediction"] == next(s for s in spans if s.name == "inference").seconds


def test_trace_names_the_spans_and_marks_the_roots_profiled(model, image, tmp_path):
    mark = _mark()
    with profiling.trace(str(tmp_path)):
        assert SPANS.tracing
        get_sliced_prediction(image, model, **SLICED)
    assert not SPANS.tracing
    spans = _since(mark)
    (root,) = [s for s in spans if s.parent is None]
    assert root.profiled is True and all(s.profiled is None for s in spans if s is not root)
    for nms in (s for s in spans if s.name == "nms"):
        assert set(nms.counts) == {"nms_rounds"} and nms.counts["nms_rounds"] >= 1
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"request", "nms", "readback", *STAGES} <= names


def test_stream_roots_record_the_profiler_on_every_thread(model, image):
    """A profiler is the process's, so the stream's worker threads see it too."""
    from torch.profiler import ProfilerActivity, profile

    for profiled in (False, True):
        mark = _mark()
        with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
            list(predict_stream_batched([image] * 2, model, batch_size=2, window=1, raw=True, **SLICED))
        roots = [s for s in _since(mark) if s.parent is None]
        assert {s.name for s in roots} == {"stage", "upload", "enqueue", "fetch_wait"}
        assert all(s.profiled is profiled for s in roots), profiled


def test_stopwatch_phases_are_spans():
    sw = profiling.Stopwatch()
    mark = _mark()
    with sw.phase("a"):
        time.sleep(0.001)
    (span,) = _since(mark)
    assert span.name == "a" and sw.durations == {"a": span.seconds} and span.seconds >= 0.001
    assert np.isfinite(sw.durations["a"])
