"""The port's ONNX detection models (engine/onnx_wrapper.py and the
``.onnx`` branch of engine/scrfd_wrapper.py) against the JAX package's on
the CPU: the three output layouts on hand-made head outputs, the ``auto``
classification, an exported graph through the sliced pipeline, and an SCRFD
exported in insightface's nine-output layout against the ``.npz`` route.

Tolerances: hand-made outputs decode to the same detections within 1e-5;
pipelines and routes: equal counts, boxes 0.05 px, scores 1e-3, keypoints
0.1 px.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from facedet_tpu.engine.onnx_wrapper import OnnxDetectionModel as JaxOnnxModel
from facedet_tpu.engine.predict import get_sliced_prediction as jax_get_sliced_prediction
from facedet_tpu.engine.scrfd_wrapper import ScrfdDetectionModel as JaxScrfdModel
from facedet_tpu_torch import get_sliced_prediction
from facedet_tpu_torch.engine.onnx_wrapper import OnnxDetectionModel
from facedet_tpu_torch.engine.scrfd_wrapper import ScrfdDetectionModel
from facedet_tpu_torch.models import onnx_export
from facedet_tpu_torch.models import scrfd as tscrfd
from test_onnx_import import export_onnx
from test_torch_predict import _assert_close

torch.set_num_threads(1)


def fake_models(layout, out, num_keypoints=None):
    """Both wrappers around a graph that returns ``out`` whatever the tile."""
    kw = dict(load_at_init=False, output_layout=layout, image_size=64, confidence_threshold=0.3, num_keypoints=num_keypoints)
    jm = JaxOnnxModel(**kw)
    jm._onnx = lambda params, x: (jnp.asarray(out),)
    jm.variables = {"params": {}}
    tm = OnnxDetectionModel(device="cpu", **kw)
    tm._onnx = lambda params, x: (torch.from_numpy(out),)
    tm.variables = {"params": {}}
    return jm, tm


def _same_detections(jm, tm, tiles_hw=(64, 64), conf=0.3):
    want = jm.tile_forward(jm.variables, jnp.zeros((1, *tiles_hw, 3)), conf)
    got = tm.forward_tiles(torch.zeros(1, *tiles_hw, 3), conf)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], atol=1e-5)
    np.testing.assert_allclose(got.scores.numpy()[v], np.asarray(want.scores)[v], atol=1e-6)
    np.testing.assert_allclose(got.kpts.numpy()[v], np.asarray(want.kpts)[v], atol=1e-5)
    return got


def test_yolo_layout_decode():
    out = np.zeros((1, 5, 6), np.float32)
    out[0, :, 2] = [32, 20, 10, 8, 0.9]
    out[0, :, 4] = [10, 10, 4, 4, 0.1]
    det = _same_detections(*fake_models("yolo", out))
    valid = det.valid[0].numpy()
    assert valid.sum() == 1
    np.testing.assert_allclose(det.boxes[0][valid.argmax()].numpy(), [27, 16, 37, 24], atol=1e-5)
    assert float(det.scores[0][valid.argmax()]) == pytest.approx(0.9)


def test_yolo_pose_layout_keypoints():
    out = np.zeros((1, 4 + 1 + 6, 4), np.float32)
    out[0, :5, 1] = [30, 30, 8, 8, 0.8]
    out[0, 5:, 1] = [31, 29, 1.0, 33, 35, 0.9]
    det = _same_detections(*fake_models("yolo", out, num_keypoints=2))
    i = int(det.valid[0].numpy().argmax())
    np.testing.assert_allclose(det.kpts[0, i, :2].numpy(), [[31, 29, 1.0], [33, 35, 0.9]], atol=1e-5)


def test_rtdetr_layout_decode_denormalises_per_axis():
    out = np.zeros((1, 8, 5), np.float32)
    out[0, 3] = [0.5, 0.5, 0.25, 0.25, 0.7]
    det = _same_detections(*fake_models("rtdetr", out))
    valid = det.valid[0].numpy()
    assert valid.sum() == 1
    np.testing.assert_allclose(det.boxes[0][valid.argmax()].numpy(), [24, 24, 40, 40], atol=1e-4)
    # a 64x96 tile: x by the width, y by the height
    det = _same_detections(*fake_models("rtdetr", out), tiles_hw=(64, 96))
    np.testing.assert_allclose(det.boxes[0][det.valid[0].numpy().argmax()].numpy(), [36, 24, 60, 40], atol=1e-4)


def test_auto_layout_classification_and_bad_arguments():
    yolo_like = np.zeros((1, 5, 100), np.float32)
    rtdetr_like = np.zeros((1, 100, 5), np.float32)
    _, m = fake_models("auto", yolo_like)
    assert m._classify_layout(torch.from_numpy(yolo_like)) == "yolo"
    assert m._classify_layout(torch.from_numpy(rtdetr_like)) == "rtdetr"
    with pytest.raises(ValueError, match="unknown output_layout"):
        OnnxDetectionModel(output_layout="detr", device="cpu")
    with pytest.raises(ValueError, match="requires model_path"):
        OnnxDetectionModel(device="cpu")


class MicroYoloExport(nn.Module):
    """Conv trunk -> [B, 4+1, A] export-layout head."""

    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv2d(3, 8, 3, stride=8, padding=1)
        self.head = nn.Conv2d(8, 5, 1)

    def forward(self, x):
        y = self.head(torch.relu(self.c1(x))).flatten(2)  # [B, 5, A]
        return torch.cat([torch.sigmoid(y[:, :4]) * 64.0, torch.sigmoid(y[:, 4:5])], 1)


def test_exported_graph_end_to_end_matches_the_jax_pipeline(tmp_path):
    torch.manual_seed(0)
    path = str(tmp_path / "yolo_export.onnx")
    export_onnx(MicroYoloExport(), torch.randn(1, 3, 64, 64), path)
    jm = JaxOnnxModel(model_path=path, confidence_threshold=0.05)
    tm = OnnxDetectionModel(model_path=path, confidence_threshold=0.05, device="cpu")
    assert tm.image_size == jm.image_size == 64
    assert all(v.device.type == "cpu" for v in tm.variables["params"].values())
    img = (np.random.default_rng(0).random((100, 130, 3)) * 255).astype(np.uint8)
    kw = dict(slice_height=64, slice_width=64, perform_standard_pred=False)
    want = jax_get_sliced_prediction(img, jm, **kw)
    got = get_sliced_prediction(img, tm, **kw)
    assert got.detections.boxes.ndim == 2 and len(want.object_prediction_list) > 0
    _assert_close(got.object_prediction_list, want.object_prediction_list)


@pytest.fixture(scope="module")
def scrfd_graphs(tmp_path_factory):
    """scrfd_500m with seeded weights, exported at 64x64 in insightface's
    layout at batch 1."""
    d = tmp_path_factory.mktemp("scrfd_onnx")
    native = ScrfdDetectionModel(variant="scrfd_500m", dtype="float32", seed=3, device="cpu", confidence_threshold=0.3)
    fixed = str(d / "scrfd_b1.onnx")
    onnx_export.export_scrfd_onnx(native.model, 64, fixed)
    return native, fixed


def test_scrfd_onnx_route_equals_the_native_route_and_the_jax_route(scrfd_graphs):
    native, fixed = scrfd_graphs
    kw = dict(variant="scrfd_500m", dtype="float32", confidence_threshold=0.3)
    loop = ScrfdDetectionModel(model_path=fixed, device="cpu", **kw)
    jm = JaxScrfdModel(model_path=fixed, **kw)
    assert loop.image_size == 64 and loop.model is None
    tiles = np.random.default_rng(5).random((3, 64, 64, 3), np.float32)
    conf = 0.45  # random weights: scores sit around 0.5
    want = native.forward_tiles(torch.from_numpy(tiles), conf)
    jax_want = jm.tile_forward(jm.variables, jnp.asarray(tiles), conf)
    assert 0 < int(want.valid.sum())
    got = loop.forward_tiles(torch.from_numpy(tiles), conf)
    for ref_valid, ref_boxes, ref_scores, ref_kpts in (
        (want.valid.numpy(), want.boxes.numpy(), want.scores.numpy(), want.kpts.numpy()),
        (np.asarray(jax_want.valid), np.asarray(jax_want.boxes), np.asarray(jax_want.scores), np.asarray(jax_want.kpts)),
    ):
        np.testing.assert_array_equal(got.valid.numpy(), ref_valid)
        v = ref_valid
        np.testing.assert_allclose(got.boxes.numpy()[v], ref_boxes[v], atol=0.05)
        np.testing.assert_allclose(got.scores.numpy()[v], ref_scores[v], atol=1e-3)
        np.testing.assert_allclose(got.kpts.numpy()[v][..., :2], ref_kpts[v][..., :2], atol=0.1)


def test_scrfd_onnx_route_through_the_sliced_pipeline(scrfd_graphs):
    native, fixed = scrfd_graphs
    onnx_model = ScrfdDetectionModel(model_path=fixed, variant="scrfd_500m", dtype="float32", device="cpu",
                                     confidence_threshold=0.45)
    native.confidence_threshold = 0.45
    img = (np.random.default_rng(6).random((100, 130, 3)) * 255).astype(np.uint8)
    kw = dict(slice_height=64, slice_width=64, perform_standard_pred=True)
    want = get_sliced_prediction(img, native, **kw)
    got = get_sliced_prediction(img, onnx_model, **kw)
    assert len(want.object_prediction_list) > 0
    _assert_close(got.object_prediction_list, want.object_prediction_list)


def test_yolo_export_layout_through_the_onnx_model(tmp_path):
    """The port's YOLOv11-pose exported with the ultralytics head, imported
    again, against the native detector: two routes, one set of weights."""
    from facedet_tpu_torch import YoloV11PoseDetectionModel

    native = YoloV11PoseDetectionModel(scale="n", dtype="float32", seed=1, device="cpu", confidence_threshold=0.3)
    path = str(tmp_path / "yolo11n.onnx")
    onnx_export.export_yolo_onnx(native.model, 64, path)
    model = OnnxDetectionModel(model_path=path, num_keypoints=5, device="cpu", confidence_threshold=0.3)
    tiles = torch.from_numpy(np.random.default_rng(7).random((2, 64, 64, 3), np.float32))
    conf = 0.4
    want, got = native.forward_tiles(tiles, conf), model.forward_tiles(tiles, conf)
    assert torch.equal(got.valid, want.valid) and int(want.valid.sum()) > 0
    v = want.valid
    np.testing.assert_allclose(got.boxes[v].numpy(), want.boxes[v].numpy(), atol=0.05)
    np.testing.assert_allclose(got.scores[v].numpy(), want.scores[v].numpy(), atol=1e-3)
    np.testing.assert_allclose(got.kpts[v].numpy(), want.kpts[v].numpy(), atol=0.1)
