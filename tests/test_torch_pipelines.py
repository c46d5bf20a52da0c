"""The port's composed pipelines (facedet_tpu_torch/engine/pipelines.py)
against the JAX package's on the CPU, end to end: a seeded synthetic-face
image, the golden yolo11n weights in float32, and a tiny RRDB config whose
weights are carried across.

Tolerances: detections as tests/test_torch_predict.py holds them (the same
count, boxes within 0.05 px, scores within 1e-3, keypoints within 0.1 px),
in the coordinates the pipeline returns; the enhanced image equal except for
at most 0.1% of its values by one level.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from facedet_tpu.engine import enhancer as jenh
from facedet_tpu.engine import pipelines as jpipe
from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxModel
from facedet_tpu.engine.detector import save_params_npz
from facedet_tpu.models.rrdbnet import RRDBConfig as JaxRRDBConfig
from facedet_tpu_torch import YoloV11PoseDetectionModel
from facedet_tpu_torch.engine import enhancer as tenh
from facedet_tpu_torch.engine import pipelines as tpipe
from facedet_tpu_torch.models.rrdbnet import RRDBConfig
from facedet_tpu_torch.ops.tiler import fixed_grid_slice_params, half_image_slice_size
from facedet_tpu_torch.utils.config import SliceConfig
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)

CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz",
)
DIMS = dict(num_feat=8, num_block=1, num_grow_ch=4)


@pytest.fixture(scope="module")
def detectors():
    kw = dict(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.25, image_size=320)
    return JaxModel(**kw), YoloV11PoseDetectionModel(device="cpu", **kw)


@pytest.fixture(scope="module")
def enhancers(tmp_path_factory):
    """x2 enhancers with the same weights: a net that upsamples (the centre
    taps carry the top-left pixel of each 2x2 block through every conv
    outside the body, the body's contribution is small noise), so that the
    enhanced image still shows the faces."""
    j = jenh.FaceEnhancer(cfg=JaxRRDBConfig(scale=2, **DIMS), outscale=2, tile=0, half=False, device="cpu")
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: rng.normal(0, 0.01, a.shape).astype(np.float32), jax.device_get(j.variables))["params"]
    for name in ("conv_first", "conv_up1", "conv_up2", "conv_hr", "conv_last"):
        for c in range(3):
            params[name]["kernel"][1, 1, c, c] += 1.0
    j.variables = jax.tree.map(jnp.asarray, {"params": params})
    path = str(tmp_path_factory.mktemp("weights") / "tiny_x2.npz")
    save_params_npz(path, jax.device_get(j.variables))
    t = tenh.FaceEnhancer(cfg=RRDBConfig(scale=2, **DIMS), model_path=path, outscale=2, tile=0, half=False, device="cpu")
    return j, t


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


@pytest.mark.parametrize("policy", ["half_image", "fixed_grid", "fixed"])
@pytest.mark.parametrize("hw", [(512, 768), (2048, 3072), (3100, 900)])
def test_slice_params_match_jax(policy, hw):
    cfg = SliceConfig(slice_height=320, slice_width=None, overlap_height_ratio=0.25)
    assert tpipe._slice_params(policy, *hw, cfg) == jpipe._slice_params(policy, *hw, cfg)


def test_slice_params_known_values():
    assert fixed_grid_slice_params(2048, 3072) == (512, 768, 0.2)  # a 4x4 grid from 3000 px on
    assert fixed_grid_slice_params(1024, 1536) == (384, 512, 0.2)
    assert half_image_slice_size(512, 768) == (256, 512)


def test_enhance_first_pipeline_matches_jax(detectors, enhancers):
    """v2: SR on the whole image, detection on the enhanced tensor where it
    lies, boxes and keypoints divided by the scale."""
    (jdet, tdet), (j, t) = detectors, enhancers
    image = synthetic_faces(256, 384, seed=1, n=5, size=(25, 60))
    want = jpipe.enhance_first_pipeline(image, jdet, j, slice_policy="fixed_grid")
    got = tpipe.enhance_first_pipeline(image, tdet, t, slice_policy="fixed_grid")
    assert len(want.object_prediction_list) > 0
    _assert_close(got.object_prediction_list, want.object_prediction_list)
    assert got.image is not None and np.array_equal(got.image, image)
    # the display fetch of the detection doubles as the enhanced image, uint8
    assert got.enhanced_image.dtype == np.uint8 and got.enhanced_image.shape == (512, 768, 3)
    diff = np.abs(got.enhanced_image.astype(int) - np.asarray(want.enhanced_image).astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
    assert set(got.durations_in_seconds) == set(want.durations_in_seconds) and got.durations_in_seconds["enhance"] > 0
    # original coordinates: inside the original image
    boxes, _, kpts = _arrays(got.object_prediction_list)
    assert boxes[:, [0, 2]].max() <= 384 and boxes[:, [1, 3]].max() <= 256
    np.testing.assert_allclose(
        got.detections.to_numpy()["boxes"], np.asarray(want.detections.to_numpy()["boxes"]), atol=0.05
    )
    assert got.object_prediction_list[0].full_shape == [256, 384]


def test_enhance_first_pipeline_outscale_argument(detectors, enhancers):
    """An outscale other than the enhancer's (the lanczos resize) scales the
    coordinates by that factor."""
    (jdet, tdet), (j, t) = detectors, enhancers
    image = synthetic_faces(256, 384, seed=2, n=4, size=(30, 60))
    want = jpipe.enhance_first_pipeline(image, jdet, j, outscale=1.5)
    got = tpipe.enhance_first_pipeline(image, tdet, t, outscale=1.5)
    assert got.enhanced_image.shape == np.asarray(want.enhanced_image).shape == (384, 576, 3)
    _assert_close(got.object_prediction_list, want.object_prediction_list)


def test_detect_first_pipeline_matches_jax(detectors, enhancers, tmp_path):
    """v1: detection with half-image slices, crops written, crops enhanced."""
    (jdet, tdet), (j, t) = detectors, enhancers
    image = synthetic_faces(512, 768, seed=3, n=5)
    want, want_stats = jpipe.detect_first_pipeline(image, jdet, enhancer=j, crops_dir=str(tmp_path / "jax" / "crops"))
    got, stats = tpipe.detect_first_pipeline(image, tdet, enhancer=t, crops_dir=str(tmp_path / "torch" / "crops"))
    n = len(want.object_prediction_list)
    assert n > 0
    _assert_close(got.object_prediction_list, want.object_prediction_list)
    for k in ("total", "enhanced", "failed", "failed_files"):
        assert stats[k] == want_stats[k]
    assert stats["total"] == stats["enhanced"] == n and stats["failed"] == 0
    assert got.durations_in_seconds["enhance"] > 0
    names = sorted(os.listdir(tmp_path / "torch" / "crops"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "crops")) == sorted(os.listdir(tmp_path / "torch" / "crops_enhanced"))
    for name in names:
        crop = np.asarray(Image.open(tmp_path / "torch" / "crops" / name))
        a = np.asarray(Image.open(tmp_path / "torch" / "crops_enhanced" / name).convert("RGB"))
        b = np.asarray(Image.open(tmp_path / "jax" / "crops_enhanced" / name).convert("RGB"))
        assert a.shape == b.shape == (crop.shape[0] * 2, crop.shape[1] * 2, 3)
        assert np.abs(a.astype(int) - b.astype(int)).mean() < 0.5  # a JPEG of nearly equal pixels


def test_detect_first_pipeline_without_enhancer(detectors):
    _, tdet = detectors
    image = synthetic_faces(512, 768, seed=3, n=5)
    result, stats = tpipe.detect_first_pipeline(image, tdet)
    assert stats == {"total": 0, "enhanced": 0, "failed": 0}
    assert len(result.object_prediction_list) > 0 and "enhance" not in result.durations_in_seconds


@pytest.mark.parametrize("size,expected", [((35, 48), True), ((90, 160), False), ((8, 12), False)])
def test_quick_face_analysis_matches_jax(detectors, size, expected):
    jdet, tdet = detectors
    image = synthetic_faces(320, 320, seed=4, n=3, size=size)
    want = jpipe.quick_face_analysis(image, jdet)
    got = tpipe.quick_face_analysis(image, tdet)
    assert got == want == expected
    assert tdet.confidence_threshold == 0.25
