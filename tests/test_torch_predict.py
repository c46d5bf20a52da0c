"""The port's prediction drivers (engine/predict.py) against the JAX
package's on the CPU, with the golden yolo11n weights in float32, and the
port's flagship CLI.

Tolerances (the precedent of tests/test_parallel.py:116-127): the same
number of detections, boxes within 0.05 px, scores within 1e-3, keypoints
within 0.1 px. Convs sum in another order in the two frameworks.
"""
import os

import numpy as np
import pytest
import torch

from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxModel
from facedet_tpu.engine.predict import get_prediction as jax_get_prediction
from facedet_tpu.engine.predict import get_sliced_prediction as jax_get_sliced_prediction
from facedet_tpu_torch import YoloV11PoseDetectionModel, get_prediction, get_sliced_prediction
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)

CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz",
)
SLICED = dict(
    slice_height=320, slice_width=320, overlap_height_ratio=0.2, overlap_width_ratio=0.2,
    perform_standard_pred=True, postprocess_type="GREEDYNMM", postprocess_match_metric="IOS",
    postprocess_match_threshold=0.5,
)


@pytest.fixture(scope="module")
def models():
    kw = dict(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.25, image_size=320)
    return JaxModel(**kw), YoloV11PoseDetectionModel(device="cpu", **kw)


@pytest.fixture(scope="module")
def image():
    return synthetic_faces(512, 768, seed=0)


def _arrays(preds):
    return (
        np.array([p.bbox.to_xyxy() for p in preds], np.float32).reshape(-1, 4),
        np.array([p.score.value for p in preds], np.float32),
        np.array([p.keypoints for p in preds], np.float32).reshape(-1, 5, 3),
    )


def _assert_close(got, want):
    gb, gs, gk = _arrays(got)
    wb, ws, wk = _arrays(want)
    assert len(gb) == len(wb)
    np.testing.assert_allclose(gb, wb, atol=0.05)
    np.testing.assert_allclose(gs, ws, atol=1e-3)
    np.testing.assert_allclose(gk[..., :2], wk[..., :2], atol=0.1)


def test_sliced_prediction_matches_jax(models, image):
    jax_model, model = models
    want = jax_get_sliced_prediction(image, jax_model, **SLICED)
    got = get_sliced_prediction(image, model, **SLICED)
    assert len(want.object_prediction_list) > 0
    _assert_close(got.object_prediction_list, want.object_prediction_list)
    assert got.image is image and got.detections.boxes.device.type == "cpu"
    assert set(got.durations_in_seconds) == {"slice", "prediction", "postprocess"}


def test_get_prediction_matches_jax(models, image):
    jax_model, model = models
    try:
        jax_model.confidence_threshold = model.confidence_threshold = 0.05
        want = jax_get_prediction(image, jax_model)
        got = get_prediction(image, model)
    finally:
        jax_model.confidence_threshold = model.confidence_threshold = 0.25
    assert len(want.object_prediction_list) > 0
    _assert_close(got.object_prediction_list, want.object_prediction_list)


def test_tensor_input_and_fetch_compaction(models, image):
    """A torch HWC tensor in [0, 1] gives what the uint8 array gives;
    ``fetch_capacity`` only shortens the padded result."""
    _, model = models
    base = get_sliced_prediction(image, model, **SLICED)
    as_tensor = get_sliced_prediction(torch.from_numpy(image).float() / 255.0, model, **SLICED)
    _assert_close(as_tensor.object_prediction_list, base.object_prediction_list)
    assert as_tensor.image.dtype == np.uint8 and as_tensor.image.shape == image.shape
    compact = get_sliced_prediction(image, model, fetch_capacity=16, **SLICED)
    assert compact.detections.capacity == 16
    _assert_close(compact.object_prediction_list, base.object_prediction_list)


def test_get_prediction_tensor_input_stays_a_tensor(models, image):
    """A CPU tensor and the same numpy array give equal results (the tensor
    is letterboxed where it lies and fetched only for ``.image``), in uint8
    and as floats in [0, 1]."""
    _, model = models
    try:
        model.confidence_threshold = 0.05
        base = get_prediction(image, model)
        as_uint8 = get_prediction(torch.from_numpy(image), model)
        as_float = get_prediction(torch.from_numpy(image).float() / 255.0, model)
    finally:
        model.confidence_threshold = 0.25
    assert len(base.object_prediction_list) > 0
    for got in (as_uint8, as_float):
        for a, b in zip(_arrays(got.object_prediction_list), _arrays(base.object_prediction_list)):
            np.testing.assert_array_equal(a, b)
        assert isinstance(got.image, np.ndarray)
        np.testing.assert_array_equal(got.image, image)
    assert got.object_prediction_list[0].full_shape == list(image.shape[:2])


def test_unported_options_raise(models, image):
    """Nothing of these options is unported any more: a mesh that is not a
    ``DeviceMesh`` raises TypeError (the mesh itself is held by
    tests/test_torch_parallel.py), several devices are served, with the same
    result as one, the input formats and video sources run (a missing video
    file raises as in JAX)."""
    from facedet_tpu_torch import predict, predict_stream_batched

    _, model = models
    with pytest.raises(TypeError, match="DeviceMesh"):
        get_sliced_prediction(image, model, mesh=object())
    two = list(predict_stream_batched([image], model, devices=["cpu", "cpu"], raw=True))
    one = list(predict_stream_batched([image], model, raw=True))
    np.testing.assert_array_equal(two[0].boxes.numpy(), one[0].boxes.numpy())
    with pytest.raises(FileNotFoundError):
        predict(detection_model=model, source="clip.avi")
    assert len(get_sliced_prediction(image, model, input_format="yuv420", **SLICED).object_prediction_list) > 0


def test_cli_writes_folders_and_summaries(tmp_path):
    from facedet_tpu_torch.apps import app_yolo_sahi
    from facedet_tpu_torch.utils.viz import save_image

    inp = tmp_path / "in"
    inp.mkdir()
    for s in (1, 2):
        save_image(str(inp / f"img{s}.png"), synthetic_faces(256, 384, seed=s, n=3, size=(50, 90)))
    args = ["--input", str(inp), "--output", str(tmp_path / "out"), "--model-path", CKPT, "--scale", "n",
            "--slice", "320", "--imgsz", "320", "--device", "cpu"]
    stats = app_yolo_sahi.main(args)
    assert [os.path.basename(s["image"]) for s in stats] == ["img1.png", "img2.png"]
    for s in (1, 2):
        folder = tmp_path / "out" / f"img{s}"
        assert (folder / f"img{s}_summary.txt").exists() and (folder / f"img{s}_detections.jpg").exists()
    # the other families run behind the same CLI (the yolo checkpoint does not fit SCRFD: strict loading)
    with pytest.raises(KeyError, match="do not match"):
        app_yolo_sahi.main(args + ["--family", "scrfd"])
    fake = app_yolo_sahi.main(args[:4] + ["--family", "fake", "--slice", "128", "--imgsz", "128", "--device", "cpu"])
    assert len(fake) == 2 and all(s["faces"] > 0 for s in fake)
