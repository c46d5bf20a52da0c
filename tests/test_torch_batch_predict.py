"""The port's folder prediction (facedet_tpu_torch/engine/batch_predict.py) and
the CLI's ``--ingest`` (apps/app_yolo_sahi.py), on the CPU with the golden
yolo11n weights, mirroring tests/test_apps.py:47-62, 101-149 and 276-380.

The helpers that compute nothing on tensors (``bbox_sort``,
``agg_prediction``, ``increment_path``, ``_list_images``) are held equal to
the JAX package's. ``predict()`` and the CLI are held against the port's own
``get_sliced_prediction`` on the same files (same detections, equal boxes),
which tests/test_torch_stream.py holds against JAX.
"""
import json
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from facedet_tpu.engine import batch_predict as jbatch
from facedet_tpu_torch import YoloV11PoseDetectionModel, get_sliced_prediction, predict
from facedet_tpu_torch.data.native_loader import load_image, load_image_dct420
from facedet_tpu_torch.engine import batch_predict as tbatch
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)

CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz",
)
SLICE = dict(slice_height=160, slice_width=160)


@pytest.fixture(scope="module")
def model():
    return YoloV11PoseDetectionModel(
        model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.15, image_size=160, device="cpu"
    )


@pytest.fixture(scope="module")
def input_dir(tmp_path_factory):
    """Two 4:2:0 JPEGs (the native coefficient reader serves them) and a PNG
    in a sub-folder (the PIL path serves it)."""
    d = tmp_path_factory.mktemp("inputs")
    Image.fromarray(synthetic_faces(240, 256, seed=3, n=5, size=(30, 60))).save(d / "one.jpg", quality=92, subsampling=2)
    Image.fromarray(synthetic_faces(200, 230, seed=2, n=5, size=(30, 60))).save(d / "two.jpg", quality=92, subsampling=2)
    (d / "sub").mkdir()
    Image.fromarray(synthetic_faces(240, 256, seed=4, n=5, size=(30, 60))).save(d / "sub" / "three.png")
    return d


def _boxes(preds):
    return np.array([p.bbox.to_xyxy() for p in preds], np.float32).reshape(-1, 4)


def test_helpers_equal_jax():
    for a, b, t in (((10, 10), (50, 12), 5), ((10, 10), (5, 40), 5), ((3, 7), (3, 7), 0)):
        assert tbatch.bbox_sort(a, b, t) == jbatch.bbox_sort(a, b, t)
    assert tbatch.IMAGE_EXTENSIONS == jbatch.IMAGE_EXTENSIONS
    assert tbatch.VIDEO_EXTENSIONS == jbatch.VIDEO_EXTENSIONS
    assert tbatch.LOW_MODEL_CONFIDENCE == jbatch.LOW_MODEL_CONFIDENCE


def test_list_images_and_increment_path_equal_jax(input_dir, tmp_path):
    assert tbatch._list_images(str(input_dir)) == jbatch._list_images(str(input_dir))
    assert [os.path.basename(p) for p in tbatch._list_images(str(input_dir))] == ["one.jpg", "three.png", "two.jpg"]
    assert tbatch._list_images(str(input_dir / "one.jpg")) == [str(input_dir / "one.jpg")]
    base = tmp_path / "exp"
    assert tbatch.increment_path(str(base)) == jbatch.increment_path(str(base)) == str(base)
    base.mkdir()
    assert tbatch.increment_path(str(base)) == jbatch.increment_path(str(base)) == str(base) + "2"
    assert tbatch.increment_path(str(base), exist_ok=True) == str(base)


def test_agg_prediction_reading_order_equals_jax(model, input_dir):
    result = get_sliced_prediction(load_image(str(input_dir / "one.jpg")), model, **SLICE)
    assert len(result.object_prediction_list) >= 2
    got, want = tbatch.agg_prediction(result, 20.0), jbatch.agg_prediction(result, 20.0)
    assert got == want
    assert sorted(a["image_id"] for a in got) == list(range(len(got)))


def test_predict_folder_exports_and_increments(model, input_dir, tmp_path):
    """tests/test_apps.py:101-132."""
    out = predict(
        detection_model=model, source=str(input_dir), export_crop=True, export_pickle=True,
        project=str(tmp_path / "runs"), name="exp", verbose=0, **SLICE,
    )
    d = out["export_dir"]
    assert out["num_images"] == 3
    assert set(out["durations_in_seconds"]) == {"prediction", "slice", "export_files"}
    assert sorted(os.listdir(os.path.join(d, "visuals"))) == ["one.png", "three.png", "two.png"]
    with open(os.path.join(d, "pickles", "one.pickle"), "rb") as f:
        preds = pickle.load(f)
    want = get_sliced_prediction(load_image(str(input_dir / "one.jpg")), model, **SLICE)
    np.testing.assert_allclose(_boxes(preds), _boxes(want.object_prediction_list), atol=1e-4)
    assert len(os.listdir(os.path.join(d, "crops", "one"))) == len(preds) > 0
    out2 = predict(
        detection_model=model, source=str(input_dir / "one.jpg"), novisual=True, export_pickle=True,
        project=str(tmp_path / "runs"), name="exp", verbose=0, **SLICE,
    )
    assert out2["export_dir"].endswith("exp2") and out2["num_images"] == 1


@pytest.mark.parametrize("ingest", ["yuv420", "dct420", "dct420s"])
def test_predict_folder_ingest_formats(model, input_dir, tmp_path, ingest):
    """tests/test_apps.py:361-390: images load as planes or coefficients, the
    detections are those of the format's own sliced call, and the visuals
    are drawn on the reconstructed RGB."""
    out = predict(
        detection_model=model, source=str(input_dir), export_pickle=True, no_standard_prediction=True,
        project=str(tmp_path / "runs"), verbose=0, ingest=ingest, **SLICE,
    )
    assert out["num_images"] == 3
    d = out["export_dir"]
    assert Image.open(os.path.join(d, "visuals", "two.png")).size == (230, 200)
    if ingest != "yuv420":
        with open(os.path.join(d, "pickles", "two.pickle"), "rb") as f:
            preds = pickle.load(f)
        want = get_sliced_prediction(
            load_image_dct420(str(input_dir / "two.jpg")), model, input_format=ingest,
            perform_standard_pred=False, **SLICE,
        )
        np.testing.assert_allclose(_boxes(preds), _boxes(want.object_prediction_list), atol=1e-4)
    with pytest.raises(ValueError, match="sliced path"):
        predict(detection_model=model, source=str(input_dir), no_sliced_prediction=True, ingest=ingest, verbose=0)


def test_predict_low_confidence_switches_to_nms(model, input_dir, tmp_path, monkeypatch):
    """tests/test_apps.py:135-148 and engine/batch_predict.py:261-264: below
    0.1 the merge becomes NMS/IOU unless the caller forces its type."""
    seen = []
    real = get_sliced_prediction

    def spy(image, detection_model, **kw):
        seen.append((kw["postprocess_type"], kw["postprocess_match_metric"]))
        return real(image, detection_model, **kw)

    monkeypatch.setattr("facedet_tpu_torch.engine.predict.get_sliced_prediction", spy)
    kw = dict(detection_model=model, source=str(input_dir / "one.jpg"), novisual=True,
              project=str(tmp_path / "runs"), verbose=0, **SLICE)
    try:
        assert predict(model_confidence_threshold=0.05, **kw)["num_images"] == 1
        predict(model_confidence_threshold=0.05, force_postprocess_type=True, **kw)
        predict(model_confidence_threshold=0.15, **kw)
    finally:
        model.confidence_threshold = 0.15
    assert seen == [("NMS", "IOU"), ("GREEDYNMM", "IOS"), ("GREEDYNMM", "IOS")]


def test_predict_class_exclusion_and_standard_only(model, input_dir, tmp_path):
    """tests/test_apps.py:276-298."""
    kw = dict(detection_model=model, source=str(input_dir / "one.jpg"), novisual=True, export_pickle=True,
              project=str(tmp_path / "runs_excl"), verbose=0, **SLICE)
    out = predict(exclude_classes_by_name=["face"], **kw)
    with open(os.path.join(out["export_dir"], "pickles", "one.pickle"), "rb") as f:
        assert pickle.load(f) == []
    out = predict(exclude_classes_by_id=[7], no_sliced_prediction=True, **kw)
    with open(os.path.join(out["export_dir"], "pickles", "one.pickle"), "rb") as f:
        assert len(pickle.load(f)) > 0
    with pytest.raises(ValueError, match="cannot both be True"):
        predict(no_standard_prediction=True, no_sliced_prediction=True, **kw)
    with pytest.raises(ValueError, match="detection_model is required"):
        predict(source=str(input_dir))


def test_predict_coco_export(model, input_dir, tmp_path):
    """tests/test_apps.py:308-338."""
    coco = {
        "images": [
            {"id": 11, "file_name": "one.jpg", "width": 256, "height": 240},
            {"id": 22, "file_name": "two.jpg", "width": 230, "height": 200},
        ],
        "annotations": [],
        "categories": [{"id": 0, "name": "face"}],
    }
    coco_path = tmp_path / "ds.json"
    coco_path.write_text(json.dumps(coco))
    out = predict(
        detection_model=model, source=str(input_dir), dataset_json_path=str(coco_path), novisual=True,
        project=str(tmp_path / "runs"), verbose=0, **SLICE,
    )
    with open(os.path.join(out["export_dir"], "result.json")) as f:
        results = json.load(f)
    assert {r["image_id"] for r in results} == {11, 22}
    assert all(len(r["bbox"]) == 4 and "score" in r for r in results)


def test_predict_video_source_is_not_ported(model):
    """A video source goes to predict_video (ported since this test was
    written; tests/test_torch_video.py runs it): a missing file raises what
    the JAX package's predict raises for it."""
    import shutil

    missing = {"CLIP.AVI": FileNotFoundError, "frames.y4m": FileNotFoundError}
    if shutil.which("ffmpeg") is None:
        missing["clip.mp4"] = RuntimeError  # no ffprobe to read the header
    for name, error in missing.items():
        for run in (predict, jbatch.predict):
            with pytest.raises(error):
                run(detection_model=model, source=name)
    assert tbatch.predict_video.__name__ == jbatch.predict_video.__name__


def test_predict_fiftyone_with_stub(model, input_dir, monkeypatch):
    """tests/test_apps.py:151: the dataset-assembly half, through a stub
    ``fiftyone`` module."""
    class Sample(dict):
        def __init__(self, filepath):
            super().__init__()
            self.filepath = filepath
            self.saved = False

        def save(self):
            self.saved = True

    samples = [Sample(str(input_dir / "one.jpg")), Sample(str(input_dir / "two.jpg"))]
    fo = types.ModuleType("fiftyone")
    fo.types = types.SimpleNamespace(COCODetectionDataset="coco")
    fo.Dataset = types.SimpleNamespace(from_dir=lambda **kw: samples)
    fo.Detections = lambda detections: {"detections": detections}
    fo.Detection = lambda **kw: kw
    monkeypatch.setitem(sys.modules, "fiftyone", fo)
    dataset = tbatch.predict_fiftyone(
        detection_model=model, dataset_json_path="ds.json", image_dir=str(input_dir),
        slice_height=160, slice_width=160, launch_app=False, verbose=0,
    )
    assert all(s.saved for s in dataset)
    dets = dataset[0]["predictions"]["detections"]
    assert len(dets) > 0 and all(0.0 <= v <= 1.0 for v in dets[0]["bounding_box"])


@pytest.mark.parametrize("ingest", ["yuv420", "dct420", "dct420s"])
def test_cli_ingest_formats(model, input_dir, tmp_path, ingest):
    """tests/test_apps.py:46-61: ``--ingest`` from a real JPEG through the
    loaders, the pipeline and the drawings on the reconstructed RGB."""
    from facedet_tpu_torch.apps import app_yolo_sahi

    s = app_yolo_sahi.process_single_image(
        str(input_dir / "one.jpg"), model, str(tmp_path / f"out_{ingest}"), slice_size=160, overlap=0.2, ingest=ingest
    )
    rgb = app_yolo_sahi.process_single_image(
        str(input_dir / "one.jpg"), model, str(tmp_path / "out_rgb"), slice_size=160, overlap=0.2
    )
    assert s["faces"] == rgb["faces"] > 0
    d = tmp_path / f"out_{ingest}" / "one"
    assert (d / "one_detections.jpg").exists() and (d / "one_summary.txt").exists()
    assert len(list((d / "crops").iterdir())) == s["crops"]


def test_cli_main_with_ingest_on_png(tmp_path, input_dir):
    """The CLI end to end with ``--ingest yuv420`` on a PNG: the loader's
    PIL path serves files libjpeg's raw path does not read."""
    from facedet_tpu_torch.apps import app_yolo_sahi

    stats = app_yolo_sahi.main([
        "--input", str(input_dir / "sub"), "--output", str(tmp_path / "out"), "--model-path", CKPT,
        "--scale", "n", "--slice", "160", "--imgsz", "160", "--conf", "0.15", "--device", "cpu",
        "--ingest", "yuv420",
    ])
    assert [os.path.basename(s["image"]) for s in stats] == ["three.png"] and stats[0]["faces"] > 0
    assert (tmp_path / "out" / "three" / "three_detections.jpg").exists()
