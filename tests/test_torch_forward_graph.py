"""The detector's CUDA graphs (engine/detector.ForwardGraphs): the YOLO11
pre-NMS chain (forward, decode, top-k) replayed from one graph per tile
shape, the per-tile NMS run eagerly on its outputs.

On the CPU the chain runs eagerly, and the cache's bookkeeping (keys, LRU,
failed captures, invalidation, the lock) is held through a stub capture.
The tests marked ``cuda`` skip where torch sees no card; on the card,
replay must be bitwise equal to the eager chain. This file imports neither
jax nor the JAX package, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_forward_graph.py
"""
import copy
import os
import sys
import threading

import numpy as np
import pytest
import torch

from facedet_tpu_torch import YoloV11PoseDetectionModel, get_sliced_prediction
from facedet_tpu_torch.core.detections import Detections
from facedet_tpu_torch.engine.detector import ForwardGraphs, _exact_float32, graph_key
from facedet_tpu_torch.models import quantize as Q
from facedet_tpu_torch.models.layers import ConvBnAct, Int8ConvBnAct
from facedet_tpu_torch.models.yolo_decode import decode_predictions, decode_to_detections
from facedet_tpu_torch.ops.nms import nms
from facedet_tpu_torch.utils.profiling import SPANS
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")
FIELDS = ("boxes", "scores", "classes", "kpts", "valid")
SIZE = 128


def _tiles(n, h, w, dtype=torch.float32, device="cpu", seed=0):
    """``n`` NCHW tiles in [0, 1], each a synthetic photo with faces of 50
    to 64 px (128-px tiles: one face) or of 50 to 140 px (three)."""
    small = h <= SIZE
    arr = np.stack([synthetic_faces(h, w, seed=seed + i, n=1 if small else 3, size=(50, 64) if small else (50, 140))
                    for i in range(n)])
    return torch.from_numpy(arr).permute(0, 3, 1, 2).contiguous().to(device=device, dtype=dtype) / 255.0


def _eager(det, tiles, conf):
    """The chain as it ran before the graphs: one eager pass with the NMS
    inside ``decode_to_detections``."""
    with torch.inference_mode(), _exact_float32(det.dtype == "float32"):
        preds = decode_predictions(det.model.forward_nchw(tiles))
        return decode_to_detections(preds, conf_threshold=conf, max_detections=det.max_detections_per_tile,
                                    nms_iou=0.7, class_agnostic=True)


def _equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def _detector_counts():
    """The counters of the ``detector`` spans closed since the ring was emptied."""
    return [s.counts for s in SPANS.spans() if s.name == "detector"]


def _epilogues(det):
    """The BatchNorm epilogues one forward of ``det`` counts: each
    ``ConvBnAct``'s through the kernel on the card and through PyTorch ops
    elsewhere, each ``Int8ConvBnAct``'s through PyTorch ops."""
    mods = list(det.model.modules())
    fused = sum(isinstance(m, ConvBnAct) for m in mods)
    plain = sum(isinstance(m, Int8ConvBnAct) for m in mods)
    if det.device.type != "cuda":
        fused, plain = 0, fused + plain
    return {k: n for k, n in (("epilogue_kernel", fused), ("epilogue_plain", plain)) if n}


@pytest.fixture(scope="module")
def cpu_model():
    return YoloV11PoseDetectionModel(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.25,
                                     image_size=SIZE, device="cpu")


class StubGraph:
    """A capture's stand-in: a static input and a static output that every
    call overwrites, as a replayed CUDA graph does. Its ``pre`` runs at each
    call and counts there, so it brings no counts of its own."""

    def __init__(self, pre, tiles):
        self.pre, self.tiles = pre, tiles.clone()
        self.out = pre(self.tiles)
        self.counts = {}

    def __call__(self, tiles):
        self.tiles.copy_(tiles)
        self.out.copy_(self.pre(self.tiles))
        return self.out


def _stub_graphs(captured=None, fail=False):
    """A ``ForwardGraphs`` whose capture is a ``StubGraph`` (or raises),
    logging each capture's tiles shape in ``captured``."""

    def capture(pre, tiles):
        if captured is not None:
            captured.append(tuple(tiles.shape))
        if fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        return StubGraph(pre, tiles)

    return ForwardGraphs(capture=capture)


def _double(x):
    return 2 * x


def _own(out):
    return out.clone()


def _key(n):
    return graph_key(torch.empty(n, 3, 8, 8), 0.25, 300)


# --- CPU -----------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_cpu_forward_runs_eagerly_under_a_detector_span(cpu_model, layout):
    tiles = _tiles(2, SIZE, SIZE)
    SPANS.ring.clear()
    with SPANS.span("forward.tiles") as outer:
        if layout == "nchw":
            got = cpu_model.tile_forward_nchw(tiles, 0.25)
        else:
            got = cpu_model.tile_forward(tiles.permute(0, 2, 3, 1), 0.25)
        again = cpu_model.tile_forward_nchw(tiles, 0.25)
    assert _equal(got, _eager(cpu_model, tiles, 0.25)) and _equal(again, got)
    assert int(got.valid.sum()) > 0
    spans = SPANS.spans()
    dets = [s for s in spans if s.name == "detector"]
    assert [s.counts for s in dets] == [{"graph_eager": 1, "epilogue_plain": 87}] * 2
    assert _epilogues(cpu_model) == {"epilogue_plain": 87}
    assert all(s.parent is outer for s in dets)
    # the NMS follows its detector span, a child of the same forward span
    children = [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.parent is outer]
    assert children == ["detector", "nms"] * 2
    assert len(cpu_model.forward_graphs) == 0


@pytest.mark.parametrize("conf", [0.05, 0.25, 0.6])
def test_nms_after_the_top_k_is_the_decode_with_nms(cpu_model, conf):
    tiles = _tiles(3, SIZE, SIZE, seed=5)
    with torch.inference_mode():
        preds = decode_predictions(cpu_model.model.forward_nchw(tiles))
        split = nms(decode_to_detections(preds, conf_threshold=conf, max_detections=100, with_nms=False),
                    iou_threshold=0.7, class_agnostic=True)
        fused = decode_to_detections(preds, conf_threshold=conf, max_detections=100, nms_iou=0.7,
                                     class_agnostic=True)
    assert _equal(split, fused)


@pytest.mark.parametrize("change", ["shape", "stride", "dtype", "device", "conf", "max_detections"])
def test_the_key_tells_apart_what_a_capture_bakes_in(change):
    tiles = torch.empty(6, 3, 64, 64)
    base = graph_key(tiles, 0.3, 300)
    assert graph_key(tiles.clone(), 0.3, 300) == base
    other = {
        "shape": lambda: graph_key(torch.empty(6, 3, 64, 96), 0.3, 300),
        "stride": lambda: graph_key(torch.empty(6, 64, 64, 3).permute(0, 3, 1, 2), 0.3, 300),
        "dtype": lambda: graph_key(tiles.to(torch.bfloat16), 0.3, 300),
        "device": lambda: graph_key(torch.empty(6, 3, 64, 64, device="meta"), 0.3, 300),
        "conf": lambda: graph_key(tiles, 0.25, 300),
        "max_detections": lambda: graph_key(tiles, 0.3, 100),
    }[change]()
    assert other != base


def test_a_key_captures_once_then_replays():
    captured = []
    graphs = _stub_graphs(captured)
    model = object()
    x = torch.arange(4.0)
    SPANS.ring.clear()
    outs = [graphs(model, _double, x + k, _key(1), _own) for k in range(3)]
    assert [o.tolist() for o in outs] == [(2 * (x + k)).tolist() for k in range(3)]
    assert captured == [(4,)]
    assert _detector_counts() == [{"graph_captures": 1}, {"graph_replays": 1}, {"graph_replays": 1}]


def test_the_least_recently_used_key_goes_first():
    captured = []
    graphs = _stub_graphs(captured)
    model = object()
    x = torch.ones(2)
    for n in range(1, 9):
        graphs(model, _double, x, _key(n), _own)
    graphs(model, _double, x, _key(1), _own)  # 1 becomes the most recent
    graphs(model, _double, x, _key(9), _own)  # evicts 2, the least recent
    assert len(graphs) == ForwardGraphs.MAX_KEYS
    assert graphs.keys() == [_key(n) for n in (3, 4, 5, 6, 7, 8, 1, 9)]
    graphs(model, _double, x, _key(2), _own)  # captured anew, evicting 3
    assert len(captured) == 10 and _key(3) not in graphs.keys()


def test_a_failed_capture_runs_that_key_eagerly_for_good():
    captured = []
    graphs = _stub_graphs(captured, fail=True)
    model = object()
    SPANS.ring.clear()
    outs = [graphs(model, _double, torch.full((3,), float(k)), _key(1), _own) for k in range(3)]
    assert [o.tolist() for o in outs] == [[2.0 * k] * 3 for k in range(3)]
    assert len(captured) == 1 and len(graphs) == 0
    assert _detector_counts() == [{"graph_eager": 1}] * 3


def test_no_key_runs_eagerly_and_keeps_nothing():
    graphs = _stub_graphs()
    SPANS.ring.clear()
    assert graphs(object(), _double, torch.ones(2), None, _own).tolist() == [2.0, 2.0]
    assert len(graphs) == 0 and _detector_counts() == [{"graph_eager": 1}]


@pytest.mark.parametrize("how", ["replica", "load_model", "unload_model", "quantize", "new_model", "copy"])
def test_a_replaced_model_starts_with_no_graph(how):
    det = YoloV11PoseDetectionModel(scale="n", dtype="float32", image_size=SIZE, device="cpu")
    det.forward_graphs = graphs = _stub_graphs()
    x = torch.ones(2)
    graphs(det.model, _double, x, _key(1), _own)
    assert len(graphs) == 1
    if how == "replica":
        rep = det.replica("cpu")
        assert rep.forward_graphs is not graphs and len(rep.forward_graphs) == 0 and len(graphs) == 1
    elif how == "load_model":
        det.load_model()
        assert len(det.forward_graphs) == 0
    elif how == "unload_model":
        det.unload_model()
        assert len(det.forward_graphs) == 0
    elif how == "quantize":
        assert Q.quantize_detector(det, n_calib=1) > 10
        assert len(det.forward_graphs) == 0
    elif how == "new_model":  # as a trainer's eval hands the detector a fresh copy
        det.model = copy.deepcopy(det.model)
        SPANS.ring.clear()
        graphs(det.model, _double, x, _key(2), _own)
        assert graphs.keys() == [_key(2)] and _detector_counts() == [{"graph_captures": 1}]
    else:
        for twin in (copy.copy(graphs), copy.deepcopy(graphs)):
            assert isinstance(twin, ForwardGraphs) and twin is not graphs and len(twin) == 0


def test_concurrent_calls_get_their_own_outputs():
    """Eight threads share one cache whose stub graphs overwrite one static
    output per key, with the interpreter switching threads as often as it
    can: the lock keeps each call's replay and its ``post`` together."""
    graphs = _stub_graphs()
    model = object()
    errors = []

    def worker(w):
        try:
            for i in range(300):
                v = float(1000 * w + i)
                out = graphs(model, _double, torch.full((64,), v), _key(1 + i % 3), _own)
                if not torch.equal(out, torch.full((64,), 2 * v)):
                    errors.append((w, i))
        except Exception as exc:  # noqa: BLE001 - reported by the assertion below
            errors.append(repr(exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(graphs) == 3


# --- the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _card_detector(kind, device):
    """The benchmark's detector (golden weights, 640, confidence 0.3) in
    ``kind``: bfloat16, float32, or int8 (quantized from bfloat16, the
    check's control)."""
    det = YoloV11PoseDetectionModel(model_path=CKPT, scale="n", image_size=640, confidence_threshold=0.3,
                                    dtype="float32" if kind == "float32" else "bfloat16", device=device)
    if kind == "int8":
        Q.quantize_detector(det)
    return det


SHAPES = {"tiles_6x640": (6, 640, 640), "full_1x640": (1, 640, 640), "v2_16x512x704": (16, 512, 704)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8"])
def test_replay_is_bitwise_the_eager_chain(cuda, kind, shape):
    det = _card_detector(kind, cuda)
    n, h, w = SHAPES[shape]
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    first, second = _tiles(n, h, w, dtype, cuda, seed=1), _tiles(n, h, w, dtype, cuda, seed=50)
    SPANS.ring.clear()
    got = [det.tile_forward_nchw(t, 0.05) for t in (first, second, first)]
    torch.cuda.synchronize()
    e = _epilogues(det)
    assert sum(e.values()) == 87 and ("epilogue_plain" in e) == (kind == "int8")
    assert _detector_counts() == [{"graph_captures": 1, **e}, {"graph_replays": 1, **e}, {"graph_replays": 1, **e}]
    want = [_eager(det, t, 0.05) for t in (first, second)]
    assert _equal(got[0], want[0]) and _equal(got[1], want[1]) and _equal(got[2], want[0])
    assert int(want[0].valid.sum()) > 0


@pytest.mark.cuda
def test_a_result_outlives_the_next_replay(cuda):
    det = _card_detector("bfloat16", cuda)
    first, second = (_tiles(6, 640, 640, torch.bfloat16, cuda, seed=s) for s in (3, 30))
    got = det.tile_forward_nchw(first, 0.05)
    kept = got.map(torch.clone)
    other = det.tile_forward_nchw(second, 0.05)
    det.tile_forward_nchw(second, 0.05)
    torch.cuda.synchronize()
    assert _equal(got, kept) and not _equal(got, other)


@pytest.mark.cuda
def test_capture_succeeds_while_another_thread_copies_on_its_own_stream(cuda):
    det = _card_detector("bfloat16", cuda)
    tiles = _tiles(6, 640, 640, torch.bfloat16, cuda, seed=7)
    host = torch.empty(64 << 20, dtype=torch.uint8).pin_memory()
    stop, copies, errors = threading.Event(), [], []

    def stage():  # a staging worker: uploads on its own stream, waiting on each
        stream = torch.cuda.Stream(cuda)
        try:
            while not stop.is_set():
                with torch.cuda.stream(stream):
                    dev = host.to(cuda, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                done.synchronize()
                copies.append(dev.numel())
        except Exception as exc:  # noqa: BLE001 - reported by the assertion below
            errors.append(repr(exc))

    worker = threading.Thread(target=stage)
    worker.start()
    try:
        while not copies:
            stop.wait(0.001)
        SPANS.ring.clear()
        got = det.tile_forward_nchw(tiles, 0.05)
        again = det.tile_forward_nchw(tiles, 0.05)
        torch.cuda.synchronize()
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive() and errors == []
    e = _epilogues(det)
    assert _detector_counts() == [{"graph_captures": 1, **e}, {"graph_replays": 1, **e}]
    want = _eager(det, tiles, 0.05)
    assert _equal(got, want) and _equal(again, want)


@pytest.mark.cuda
def test_sliced_prediction_answers_as_the_eager_pipeline(cuda, monkeypatch):
    """A whole photo through ``get_sliced_prediction`` (six tiles and the
    standard pass, two keys): the same merged detections with the graphs as
    with the chain forced eager."""
    det = _card_detector("bfloat16", cuda)
    image = synthetic_faces(1024, 1536, seed=11, n=12, size=(50, 140))
    kw = dict(slice_height=640, slice_width=640, overlap_height_ratio=0.2, overlap_width_ratio=0.2)
    SPANS.ring.clear()
    graphed = [get_sliced_prediction(image, det, **kw).detections for _ in range(3)]
    counts = _detector_counts()
    e = _epilogues(det)
    assert counts[:2] == [{"graph_captures": 1, **e}] * 2 and counts[2:] == [{"graph_replays": 1, **e}] * 4
    assert len(det.forward_graphs) == 2
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    SPANS.ring.clear()
    eager = get_sliced_prediction(image, det, **kw).detections
    assert _detector_counts() == [{"graph_eager": 1, **e}] * 2
    for got in graphed:
        assert isinstance(got, Detections) and _equal(got, eager)
    assert int(eager.valid.sum()) > 0
