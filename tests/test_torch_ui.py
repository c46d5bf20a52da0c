"""The port's UI helpers (facedet_tpu_torch/utils/viz_mpl.py,
apps/streamlit_app.py, apps/streamlit_eval_page.py) against the JAX
package's on the CPU, with each package's fake blob detector.

Tolerances: everything here is host code over equal detections, so the
results are equal: the matplotlib rendering pixel for pixel, the crops and
summaries byte for byte, ``process_single_image``'s counts, drawings, crop
files and IQA numbers, ``collect_artifacts``'s dict. Without streamlit
``run_ui`` and ``run_page`` raise ImportError in both packages.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from facedet_tpu.apps import streamlit_app as japp
from facedet_tpu.apps import streamlit_eval_page as jpage
from facedet_tpu.engine.fake import FakeBlobDetectionModel as JaxFake
from facedet_tpu.engine.predict import get_sliced_prediction as jax_sliced
from facedet_tpu.utils import viz_mpl as jmpl
from facedet_tpu_torch.apps import streamlit_app as tapp
from facedet_tpu_torch.apps import streamlit_eval_page as tpage
from facedet_tpu_torch.engine.fake import FakeBlobDetectionModel
from facedet_tpu_torch.engine.predict import get_sliced_prediction
from facedet_tpu_torch.utils import viz_mpl as tmpl

torch.set_num_threads(1)


def make_image(h, w, dots):
    """tests/test_apps.py's image: white 3x3 dots on black."""
    img = np.zeros((h, w, 3), np.uint8)
    for y, x in dots:
        img[y - 1 : y + 2, x - 1 : x + 2] = 255
    return img


@pytest.fixture(scope="module")
def detections():
    img = make_image(100, 120, [(30, 40), (70, 90)])
    kw = dict(slice_height=64, slice_width=64, overlap_height_ratio=0.2, overlap_width_ratio=0.2)
    got = get_sliced_prediction(img, FakeBlobDetectionModel(confidence_threshold=0.5, device="cpu"), **kw)
    want = jax_sliced(img, JaxFake(confidence_threshold=0.5), **kw)
    return img, got.object_prediction_list, want.object_prediction_list


def test_face_visualizer_draws_saves_and_summarises_as_jax(detections, tmp_path):
    img, got, want = detections
    assert len(got) == len(want) == 2
    pytest.importorskip("matplotlib")
    drawn = tmpl.FaceVisualizer().draw_detections(img, got, title="faces")
    np.testing.assert_array_equal(drawn, jmpl.FaceVisualizer().draw_detections(img, want, title="faces"))
    assert drawn.shape[2] == 3
    a = tmpl.FaceVisualizer().save_face_crops(img, got, str(tmp_path / "port"))
    b = jmpl.FaceVisualizer().save_face_crops(img, want, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b] and len(a) == 2
    for p, q in zip(a, b):
        assert open(p, "rb").read() == open(q, "rb").read()
    rows = [[5, 5, 30, 40, 0.9], [0, 0, 0, 10]]
    assert [os.path.basename(p) for p in tmpl.FaceVisualizer().save_face_crops(img, rows, str(tmp_path / "r"))] \
        == ["face_crop_1_conf_0.90.jpg"]
    stats = {"image_path": "x.jpg", "num_faces": 2, "processing_time": 0.5, "avg_confidence": 0.7,
             "detections": [{"bbox": [1, 2, 3, 4], "confidence": 0.8}]}
    path = str(tmp_path / "summary.txt")
    assert tmpl.FaceVisualizer().create_detection_summary(stats, path) == \
        jmpl.FaceVisualizer().create_detection_summary(stats)
    assert open(path).read().startswith("=== Face Detection Summary ===")


@pytest.mark.parametrize("enable_sahi", [True, False])
def test_process_single_image_as_the_jax_app(tmp_path, enable_sahi):
    img = make_image(100, 120, [(30, 40)])
    kw = dict(enable_sahi=enable_sahi, confidence=0.5, with_iqa=enable_sahi)
    got = tapp.process_single_image(img, FakeBlobDetectionModel(confidence_threshold=0.5, image_size=64,
                                                                device="cpu"),
                                    output_dir=str(tmp_path / "port"), **kw)
    want = japp.process_single_image(img, JaxFake(confidence_threshold=0.5, image_size=64),
                                     output_dir=str(tmp_path / "jax"), **kw)
    assert got["num_faces"] == want["num_faces"] == 1
    assert got["annotated"].shape == img.shape
    np.testing.assert_array_equal(got["annotated"], want["annotated"])
    np.testing.assert_array_equal(got["annotated_clean"], want["annotated_clean"])
    assert [os.path.basename(p) for p in got["crop_paths"]] == [os.path.basename(p) for p in want["crop_paths"]]
    for p, q in zip(got["crop_paths"], want["crop_paths"]):
        assert open(p, "rb").read() == open(q, "rb").read()
    for key in ("iqa_original", "crop_quality"):
        assert (key in got) == (key in want) == enable_sahi
        if enable_sahi:
            assert json.dumps(got[key], sort_keys=True) == json.dumps(want[key], sort_keys=True)
    assert set(got["timings"]) == set(want["timings"]) == {"detection", "total"}


def test_collect_artifacts_and_streamlit_entry_points(tmp_path):
    for name in ("pr_curve_all.png", "pr_curve_hard.png", "dual_eval_chart.png", "other.png"):
        (tmp_path / name).write_bytes(b"png")
    (tmp_path / "official_eval_results.json").write_text(json.dumps({"aps": {"all": 0.5}}))
    (tmp_path / "best_sahi_config.json").write_text(json.dumps({"slice_size": 640}))
    got = tpage.collect_artifacts(str(tmp_path))
    assert got == jpage.collect_artifacts(str(tmp_path))
    assert len(got["images"]) == 3 and set(got["json"]) == {"official_eval_results.json", "best_sahi_config.json"}
    assert tpage.collect_artifacts(str(tmp_path / "none")) == {"images": [], "json": {}}
    if importlib.util.find_spec("streamlit") is not None:
        pytest.skip("streamlit is installed: the pages would start")
    for run in (tapp.run_ui, tpage.run_page, japp.run_ui, jpage.run_page):
        with pytest.raises(ImportError):
            run()
