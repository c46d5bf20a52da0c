"""The detector families behind the port's sliced pipeline against the JAX
pipeline on the CPU: ``get_sliced_prediction`` with ``scrfd`` (golden
weights), ``rtdetr`` (seeded ``rtdetr-tiny``), ``onnx`` (an exported graph)
and ``fake`` on one seeded 256x384 image, in float32; ``build_detector`` for
the five families; the three CLIs this slice adds.

The JAX side gathers its tiles with the XLA gather (``use_pallas_gather``
is off by default), as its own tests do.

Tolerances (those of tests/test_torch_predict.py): equal counts, boxes 0.05 px, scores 1e-3, keypoints
0.1 px.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.apps.common import build_detector as jax_build_detector
from facedet_tpu.engine.predict import get_sliced_prediction as jax_get_sliced_prediction
from facedet_tpu.models import rtdetr as jax_rtdetr
from facedet_tpu.utils.config import DetectorConfig as JaxDetectorConfig
from facedet_tpu_torch import get_sliced_prediction, get_sliced_prediction_batch
from facedet_tpu_torch.apps.common import build_detector
from facedet_tpu_torch.utils.config import DetectorConfig
from facedet_tpu_torch.utils.synth import synthetic_faces
from facedet_tpu_torch.utils.viz import save_image
from test_onnx_import import export_onnx
from test_torch_onnx_wrapper import MicroYoloExport
from test_torch_predict import _assert_close
from test_torch_rtdetr import save_flat_npz
from test_torch_scrfd import CKPT as SCRFD_CKPT
from test_torch_scrfd import seeded_variables

torch.set_num_threads(1)

SLICED = dict(
    slice_height=128, slice_width=128, overlap_height_ratio=0.2, overlap_width_ratio=0.2,
    perform_standard_pred=True, postprocess_type="GREEDYNMM", postprocess_match_metric="IOS",
    postprocess_match_threshold=0.5,
)


@pytest.fixture(scope="module")
def image():
    img = synthetic_faces(256, 384, seed=0, n=5, size=(40, 70))
    img[40:44, 300:304] = 255  # bright blobs for the fake detector
    img[200:204, 50:54] = 250
    return img


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    jm = jax_rtdetr.RtDetr(jax_rtdetr.RTDETR_VARIANTS["rtdetr-tiny"])
    variables = seeded_variables(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 50, gain=1.0)
    rtdetr = str(d / "rtdetr_tiny.npz")
    save_flat_npz(rtdetr, variables)
    torch.manual_seed(0)
    onnx = str(d / "micro_yolo.onnx")
    export_onnx(MicroYoloExport(), torch.randn(1, 3, 64, 64), onnx)
    return {"scrfd": SCRFD_CKPT, "rtdetr": rtdetr, "onnx": onnx, "fake": None}


def _pair(family, checkpoints, conf, image_size=128):
    kw = dict(family=family, model_path=checkpoints[family], confidence_threshold=conf, image_size=image_size, dtype="float32")
    jm = jax_build_detector(JaxDetectorConfig(**kw))
    tm = build_detector(DetectorConfig(**kw), device="cpu")
    return jm, tm


@pytest.mark.parametrize("family,conf", [("scrfd", 0.3), ("rtdetr", 0.6), ("onnx", 0.3), ("fake", 0.5)])
def test_sliced_prediction_matches_jax(family, conf, checkpoints, image):
    if family == "rtdetr":  # build_detector makes rtdetr-l: the tiny variant goes in by hand
        from facedet_tpu.engine.rtdetr_wrapper import RtDetrDetectionModel as JaxRtDetr
        from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel

        kw = dict(model_path=checkpoints["rtdetr"], variant="rtdetr-tiny", dtype="float32",
                  confidence_threshold=conf, image_size=128)
        jm, tm = JaxRtDetr(**kw), RtDetrDetectionModel(device="cpu", **kw)
    else:
        jm, tm = _pair(family, checkpoints, conf)
    kw = dict(SLICED, slice_height=64, slice_width=64) if family == "onnx" else SLICED
    want = jax_get_sliced_prediction(image, jm, **kw)
    got = get_sliced_prediction(image, tm, **kw)
    assert len(want.object_prediction_list) > 0
    _assert_close(got.object_prediction_list, want.object_prediction_list)
    # the batch pipeline gives what single calls give
    batch = get_sliced_prediction_batch([image, image[::-1].copy()], tm, **kw)
    _assert_close(batch[0].object_prediction_list, got.object_prediction_list)


def test_fake_detector_finds_the_blobs(image, checkpoints):
    _, tm = _pair("fake", checkpoints, 0.5)
    preds = get_sliced_prediction(image, tm, **SLICED).object_prediction_list
    centres = np.array([[(p.bbox.minx + p.bbox.maxx) / 2, (p.bbox.miny + p.bbox.maxy) / 2] for p in preds])
    for blob in ((301.5, 41.5), (51.5, 201.5)):  # merged over the tiles and the full-image pass that see it
        assert np.abs(centres - blob).max(axis=1).min() <= 3.0


def test_build_detector_builds_the_five_families(checkpoints):
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
    from facedet_tpu_torch.engine.fake import FakeBlobDetectionModel
    from facedet_tpu_torch.engine.onnx_wrapper import OnnxDetectionModel
    from facedet_tpu_torch.engine.scrfd_wrapper import ScrfdDetectionModel

    want = {"yolov11": YoloV11PoseDetectionModel, "scrfd": ScrfdDetectionModel, "onnx": OnnxDetectionModel,
            "fake": FakeBlobDetectionModel}
    for family, cls in want.items():
        m = build_detector(DetectorConfig(family=family, scale="n", model_path=checkpoints.get(family)), device="cpu")
        assert type(m) is cls and m.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown detector family"):
        build_detector(DetectorConfig(family="dino"), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):  # the default device is the card
        build_detector(DetectorConfig(family="fake"))


def test_build_detector_builds_rtdetr_at_its_default_variant():
    from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel

    m = build_detector(DetectorConfig(family="rtdetr"), device="cpu")
    assert type(m) is RtDetrDetectionModel and m.variant == "rtdetr-l"
    assert m.cfg.hidden_dim == 256 and m.cfg.num_queries == 300
    assert m.model.enc_score.weight.dtype == torch.bfloat16  # DetectorConfig's serving dtype


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_in")
    for s in (1, 2):
        save_image(str(d / f"img{s}.png"), synthetic_faces(128, 160, seed=s, n=2, size=(30, 50)))
    return d


def test_cli_app_retinaface(cli_inputs, tmp_path, capsys):
    from facedet_tpu_torch.apps import app_retinaface

    counts = app_retinaface.main([
        "--input", str(cli_inputs), "--output", str(tmp_path), "--model-path", SCRFD_CKPT,
        "--det-size", "128", "--det-thresh", "0.05", "--device", "cpu",
    ])
    assert set(counts) == {"img1", "img2"}
    assert (tmp_path / "img1_retinaface.jpg").exists() and (tmp_path / "img2_retinaface.jpg").exists()
    assert "img1:" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="does not exist"):
        app_retinaface.main(["--input", str(tmp_path / "nope"), "--device", "cpu"])


def test_cli_inference_direct(cli_inputs, capsys):
    from facedet_tpu_torch.apps import inference_direct

    result = inference_direct.main([
        "--input", str(cli_inputs / "img1.png"), "--family", "scrfd", "--model-path", SCRFD_CKPT,
        "--imgsz", "128", "--conf", "0.05", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert f"{len(result.object_prediction_list)} faces" in out and len(result.object_prediction_list) > 0


def test_cli_app_yolo_inference(cli_inputs, tmp_path, capsys):
    from facedet_tpu_torch.apps import app_yolo_inference

    result = app_yolo_inference.main([
        "--input", str(cli_inputs / "img2.png"), "--output", str(tmp_path), "--family", "fake",
        "--slice", "64", "--imgsz", "64", "--conf", "0.3", "--device", "cpu",
    ])
    assert len(result.object_prediction_list) > 0
    assert (tmp_path / "img2_detections.jpg").exists() and (tmp_path / "img2_summary.txt").exists()
    assert os.listdir(tmp_path / "crops")
    out = capsys.readouterr().out
    assert "faces detected" in out and "left_eye" in out
