"""The port's serving path (facedet_tpu_torch/engine/predict.py: the input
formats, the batch pipeline and the two stream functions) against the JAX
package's on the CPU, with the golden yolo11n weights in float32 at a small
canvas (one 256 bucket, 4 tiles of 160).

Tolerances (those of tests/test_torch_predict.py): the same number of
detections, boxes within 0.05 px, scores within 1e-3, keypoints within
0.1 px: convs sum in another order in the two frameworks. Port-batched
against port-single shares every kernel, so it is held tighter: boxes and
keypoints within 1e-3 px, scores within 1e-5 (batched matmuls may block
their sums differently).

Each JAX pipeline is one XLA compile, so JAX is asked once per input format
and once for the ``dct420s`` batch; orders, partial batches, size changes
and ``raw=True`` are held port-batched against port-single.
"""
import os

import numpy as np
import pytest
import torch

from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxModel
from facedet_tpu.engine.predict import get_sliced_prediction as jax_get_sliced_prediction
from facedet_tpu.engine.predict import get_sliced_prediction_batch as jax_get_sliced_prediction_batch
from facedet_tpu.ops.color import rgb_to_yuv420 as jax_rgb_to_yuv420
from facedet_tpu.ops.jpeg_dct import encode_dct420 as jax_encode_dct420
from facedet_tpu_torch import (
    YoloV11PoseDetectionModel,
    get_sliced_prediction,
    get_sliced_prediction_batch,
    predict_stream,
    predict_stream_batched,
)
from facedet_tpu_torch.engine import predict as tpredict
from facedet_tpu_torch.ops.color import rgb_to_yuv420
from facedet_tpu_torch.ops.jpeg_dct import DctImage, encode_dct420, wire_unpack_dct420s
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)

CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz",
)
SLICED = dict(
    slice_height=160, slice_width=160, overlap_height_ratio=0.2, overlap_width_ratio=0.2,
    perform_standard_pred=True, postprocess_type="GREEDYNMM", postprocess_match_metric="IOS",
    postprocess_match_threshold=0.5, postprocess_class_agnostic=True,
)
HW = (240, 256)
TO_FORMAT = {
    "rgb": (lambda im: im, lambda im: im),
    "yuv420": (rgb_to_yuv420, jax_rgb_to_yuv420),
    "dct420": (encode_dct420, jax_encode_dct420),
    "dct420s": (encode_dct420, jax_encode_dct420),
}


@pytest.fixture(scope="module")
def models():
    kw = dict(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.15, image_size=160)
    return JaxModel(**kw), YoloV11PoseDetectionModel(device="cpu", **kw)


@pytest.fixture(scope="module")
def images():
    return [synthetic_faces(*HW, seed=s, n=5, size=(30, 60)) for s in (1, 3, 4, 5)]


def _arrays(preds):
    return (
        np.array([p.bbox.to_xyxy() for p in preds], np.float32).reshape(-1, 4),
        np.array([p.score.value for p in preds], np.float32),
        np.array([p.keypoints for p in preds], np.float32).reshape(-1, 5, 3),
    )


def _assert_close(got, want, box=0.05, score=1e-3, kpt=0.1):
    gb, gs, gk = _arrays(got)
    wb, ws, wk = _arrays(want)
    assert len(gb) == len(wb)
    np.testing.assert_allclose(gb, wb, atol=box)
    np.testing.assert_allclose(gs, ws, atol=score)
    np.testing.assert_allclose(gk[..., :2], wk[..., :2], atol=kpt)


def _assert_same_port(got, want):
    _assert_close(got, want, box=1e-3, score=1e-5, kpt=1e-3)


@pytest.fixture(scope="module")
def singles(models, images):
    """Port-single results per format, shared by the port-against-port tests."""
    _, model = models
    cache = {}

    def get(fmt, i):
        if (fmt, i) not in cache:
            src = TO_FORMAT[fmt][0](images[i])
            cache[fmt, i] = get_sliced_prediction(src, model, input_format=fmt, **SLICED)
        return cache[fmt, i]

    return get


@pytest.mark.parametrize("fmt", ["yuv420", "dct420", "dct420s"])
def test_sliced_prediction_input_formats_match_jax(models, images, singles, fmt):
    jax_model, _ = models
    want = jax_get_sliced_prediction(TO_FORMAT[fmt][1](images[0]), jax_model, input_format=fmt, **SLICED)
    got = singles(fmt, 0)
    assert len(want.object_prediction_list) > 0
    _assert_close(got.object_prediction_list, want.object_prediction_list)
    # the display image is rebuilt from the planes, as in the JAX package
    assert got.image.shape == (*HW, 3) and got.image.dtype == np.uint8
    np.testing.assert_array_equal(got.image, want.image)


def test_sparse_wire_is_lossless_against_dense_planes(models, images):
    """``dct420s`` rebuilds the planes ``dct420`` uploads: equal canvases,
    bit for bit, so equal detections."""
    d = encode_dct420(images[1])
    cpu = torch.device("cpu")
    dense = tpredict._to_device(tpredict._stage_batch_host([d], "dct420", 256, 256), cpu)
    wire = tpredict._to_device(tpredict._stage_batch_host([d], "dct420s", 256, 256), cpu)
    planes = {"dct420": dense, "dct420s": wire_unpack_dct420s(wire, 1, 256, 256)}
    canvases = {fmt: tpredict.decode_canvas(p, fmt, 256, 256, torch.float32) for fmt, p in planes.items()}
    assert canvases["dct420"].shape == (1, 3, 256, 256)
    assert torch.equal(canvases["dct420"], canvases["dct420s"])
    # the padding decodes to black
    assert float(canvases["dct420"][..., 248:, :].max()) < 0.03


@pytest.mark.parametrize("fmt", ["rgb", "yuv420", "dct420", "dct420s", "tensor"])
def test_single_image_is_the_batch_of_one(models, images, singles, fmt):
    """A single call answers what a batch of one answers, bit for bit; a
    tensor input (padded on its device) answers what its numpy twin does."""
    _, model = models
    src_fmt = "rgb" if fmt == "tensor" else fmt
    src = TO_FORMAT[src_fmt][0](images[0])
    if fmt == "tensor":
        got = get_sliced_prediction(torch.from_numpy(images[0]), model, **SLICED).detections
    else:
        got = singles(fmt, 0).detections
    want = get_sliced_prediction_batch([src], model, raw=True, input_format=src_fmt, **SLICED)
    assert int(want.valid.sum()) > 0
    for field in ("boxes", "scores", "classes", "kpts", "valid"):
        assert np.array_equal(getattr(got, field).numpy(), getattr(want, field)[0].numpy()), field


def test_rgb_image_is_encoded_on_the_fly_for_dct_formats(models, images, singles):
    _, model = models
    got = get_sliced_prediction(images[0], model, input_format="dct420s", **SLICED)
    _assert_same_port(got.object_prediction_list, singles("dct420s", 0).object_prediction_list)
    np.testing.assert_array_equal(got.image, images[0])  # an RGB input is shown as it came


def test_batch_matches_jax(models, images):
    jax_model, model = models
    want = jax_get_sliced_prediction_batch(
        [jax_encode_dct420(im) for im in images[:3]], jax_model, input_format="dct420s", **SLICED
    )
    got = get_sliced_prediction_batch(
        [encode_dct420(im) for im in images[:3]], model, input_format="dct420s", **SLICED
    )
    assert len(got) == len(want) == 3
    assert sum(len(r.object_prediction_list) for r in want) >= 3
    for g, w in zip(got, want):
        _assert_close(g.object_prediction_list, w.object_prediction_list)
        np.testing.assert_array_equal(g.image, w.image)


@pytest.mark.parametrize("fmt", ["rgb", "yuv420", "dct420", "dct420s"])
def test_batch_matches_port_single(models, images, singles, fmt):
    """tests/test_engine.py:118-142 for every format, and ``raw=True``."""
    _, model = models
    srcs = [TO_FORMAT[fmt][0](im) for im in images]
    got = get_sliced_prediction_batch(srcs, model, input_format=fmt, **SLICED)
    assert len(got) == 4
    for i, g in enumerate(got):
        _assert_same_port(g.object_prediction_list, singles(fmt, i).object_prediction_list)
    raw = get_sliced_prediction_batch(srcs, model, raw=True, input_format=fmt, fetch_capacity=32, **SLICED)
    assert raw.boxes.shape == (4, 32, 4) and raw.valid.shape == (4, 32) and raw.kpts.shape == (4, 32, 5, 3)
    for i in range(4):
        want = singles(fmt, i).detections.to_numpy()
        got_i = raw.map(lambda x: x[i]).to_numpy()
        assert got_i["boxes"].shape == want["boxes"].shape
        np.testing.assert_allclose(got_i["boxes"], want["boxes"], atol=1e-3)
    assert get_sliced_prediction_batch([], model) == []


def test_batch_chunks_do_not_change_results(models, images, monkeypatch):
    """The chunk rule only bounds memory: with one image per chunk the batch
    gives what it gives in one chunk."""
    _, model = models
    srcs = [encode_dct420(im) for im in images]
    one_chunk = get_sliced_prediction_batch(srcs, model, input_format="dct420s", **SLICED)
    monkeypatch.setattr(tpredict, "_MAX_FLAT_TILES", 4)  # T = 4: chunks of one image
    chunked = get_sliced_prediction_batch(srcs, model, input_format="dct420s", **SLICED)
    for a, b in zip(chunked, one_chunk):
        _assert_same_port(a.object_prediction_list, b.object_prediction_list)


def test_batch_rejects_mixed_sizes_and_unknown_options(models, images):
    _, model = models
    with pytest.raises(ValueError, match="same-size"):
        get_sliced_prediction_batch([images[0], images[0][:200]], model, **SLICED)
    with pytest.raises(TypeError, match="unknown"):
        get_sliced_prediction_batch([images[0]], model, slice_hieght=160)
    with pytest.raises(ValueError, match="input_format"):
        get_sliced_prediction(images[0], model, input_format="yuv444", **SLICED)


def test_predict_stream_mixed_sizes(models, images, singles):
    """tests/test_apps.py:341-358 and tests/test_engine.py:99-115: sizes from
    two buckets, results in input order, and ``raw=True``."""
    _, model = models
    big = synthetic_faces(300, 420, seed=7, n=5, size=(30, 60))  # another bucket
    stream = [images[0], big, images[1]]
    results = list(predict_stream(iter(stream), model, window=2, **SLICED))
    assert len(results) == 3
    for r, im in zip(results, stream):
        want = get_sliced_prediction(im, model, **SLICED)
        _assert_same_port(r.object_prediction_list, want.object_prediction_list)
        assert r.image is im
    raw = list(predict_stream(stream[:1], model, window=2, raw=True, **SLICED))
    assert raw[0].boxes.ndim == 2 and raw[0].boxes.device.type == "cpu"
    got = [len(d.to_numpy()["scores"]) for d in predict_stream(
        [encode_dct420(im) for im in images[:2]], model, raw=True, input_format="dct420s", **SLICED)]
    assert got == [len(singles("dct420s", i).object_prediction_list) for i in range(2)]


def test_predict_stream_batched_order_partial_batch_and_size_change(models, images, singles):
    """tests/test_engine.py:165-192: batches of 2 from a stream of 4 + 1 + 2
    images whose size changes twice; results come in input order; the last
    batch of each run is partial."""
    _, model = models
    other = [synthetic_faces(200, 230, seed=s, n=5, size=(30, 60)) for s in (2, 4)]
    stream = [images[0], images[1], images[2], other[0], other[1], images[3]]
    batches = list(predict_stream_batched(iter(stream), model, batch_size=2, window=2, **SLICED))
    assert [len(b) for b in batches] == [2, 1, 2, 1]
    results = [r for b in batches for r in b]
    for r, im in zip(results, stream):
        want = get_sliced_prediction(im, model, **SLICED)
        _assert_same_port(r.object_prediction_list, want.object_prediction_list)
        assert r.image is im


@pytest.mark.parametrize("fmt", ["yuv420", "dct420s"])
def test_predict_stream_batched_raw_and_formats(models, images, singles, fmt):
    """tests/test_color.py:106-128 and tests/test_jpeg_dct.py:434-455:
    ``raw=True`` yields batched detections on the host, one per batch."""
    _, model = models
    srcs = [TO_FORMAT[fmt][0](im) for im in images[:3]]
    raws = list(predict_stream_batched(
        srcs, model, batch_size=2, window=3, raw=True, input_format=fmt, fetch_capacity=32, **SLICED))
    assert [r.boxes.shape for r in raws] == [(2, 32, 4), (1, 32, 4)]
    flat = [r.map(lambda x: x[i]) for r in raws for i in range(r.boxes.shape[0])]
    for i, det in enumerate(flat):
        assert det.boxes.device.type == "cpu"
        want = singles(fmt, i).detections.to_numpy()
        got = det.to_numpy()
        assert got["boxes"].shape == want["boxes"].shape
        np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3)
        np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5)


def test_predict_stream_batched_worker_errors_reach_the_caller(models, images):
    """An exception in the staging or dispatch worker is raised by the
    generator, not lost in a future; the workers are shut down."""
    import threading

    _, model = models
    bad = DctImage(*(np.zeros(1) for _ in range(6)), hw=HW)  # planes of the wrong shape
    gen = predict_stream_batched([encode_dct420(images[0]), bad], model, batch_size=2,
                                 input_format="dct420s", **SLICED)
    with pytest.raises((ValueError, IndexError)):
        list(gen)
    assert not [t for t in threading.enumerate() if t.name.startswith("facedet-")]


def test_unported_serving_options_raise(models, images):
    """Several devices are served now (tests/test_torch_parallel.py holds
    them against JAX); the batch path drops a mesh, as the JAX engine's
    ``_stream_opts`` does; a CUDA device where there is none raises."""
    _, model = models
    two = list(predict_stream_batched([images[0]], model, devices=["cpu", "cpu"], raw=True, **SLICED))
    assert len(two) == 1 and two[0].boxes.shape[0] == 1
    dropped = get_sliced_prediction_batch([images[0]], model, mesh=object(), raw=True, **SLICED)
    plain = get_sliced_prediction_batch([images[0]], model, raw=True, **SLICED)
    np.testing.assert_array_equal(dropped.boxes.numpy(), plain.boxes.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            list(predict_stream_batched([images[0]], model, devices=["cuda"], **SLICED))
    # one device, the model's own, is served
    out = list(predict_stream_batched([images[0]], model, devices=["cpu"], raw=True, **SLICED))
    assert len(out) == 1 and out[0].boxes.shape[0] == 1
