"""The port's golden evaluation tools (facedet_tpu_torch/tools/
golden_official_eval.py, golden_dual_eval.py, golden_conf_sweep.py) against
the JAX package's on the CPU, on a synthetic reference tree
(utils/synth.synthetic_reference_tree) with the committed golden yolo11n.

Tolerances: the WIDERFACE layout (copied JPEGs and the ground-truth text)
and the subcategory GT equal byte for byte; the blur flag equal; the
official, dual and tuning APs within 0.005 of JAX's (PERF.md §2's AP gate;
both packages run their bfloat16 detector, the tools' default) with the
same rows, categories and ground-truth counts; the confidence sweep's
detections with float32 detectors under §2's gates (equal counts, boxes
0.05 px, scores 1e-3) and its rows equal at every threshold.
"""
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from facedet_tpu.tools import golden_conf_sweep as jcs
from facedet_tpu.tools import golden_dual_eval as jde
from facedet_tpu.tools import golden_official_eval as joe
from facedet_tpu_torch.tools import golden_conf_sweep as tcs
from facedet_tpu_torch.tools import golden_dual_eval as tde
from facedet_tpu_torch.tools import golden_official_eval as toe
from facedet_tpu_torch.tools import reference_goldens as trg
from facedet_tpu_torch.utils.synth import synthetic_reference_tree

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reference"))
    synthetic_reference_tree(root, n_images=4, hw=(256, 384), n_faces=5, size=(30, 70), seed=11)
    gp = os.path.join(root, "goldens.json")
    goldens = trg.extract_goldens(root)
    with open(gp, "w") as f:
        json.dump(goldens, f)
    return root, gp, goldens


def test_layout_and_subcategory_gt_byte_for_byte(tree, tmp_path):
    root, _gp, goldens = tree
    got = toe.build_widerface_layout(goldens, root, str(tmp_path / "port"), blur_fn=tde.laplacian_blur_flag)
    want = joe.build_widerface_layout(goldens, root, str(tmp_path / "jax"), blur_fn=jde.laplacian_blur_flag)
    assert open(got[1]).read() == open(want[1]).read()
    cmp = filecmp.dircmp(got[0], want[0])
    names = sorted(os.listdir(os.path.join(got[0], toe.EVENT)))
    assert names == sorted(os.listdir(os.path.join(want[0], joe.EVENT))) and len(names) == 4
    for n in names:
        assert filecmp.cmp(os.path.join(got[0], toe.EVENT, n), os.path.join(want[0], joe.EVENT, n), shallow=False)
    assert not cmp.diff_files
    # some faces under the 0.2 confidence gate are written as ignore rows
    assert any(line.split()[7] == "1" for line in open(got[1]) if len(line.split()) == 10)
    sub = tde.build_golden_subcategory_gt(goldens, root, str(tmp_path / "sub_port"))
    jsub = jde.build_golden_subcategory_gt(goldens, root, str(tmp_path / "sub_jax"))
    assert json.dumps(sub[1:], sort_keys=True) == json.dumps(jsub[1:], sort_keys=True)
    img = (np.random.default_rng(0).random((64, 64, 3)) * 255).astype(np.uint8)
    for box in ([0, 0, 40, 40], [10, 10, 15, 30], [20.4, 8.6, 60, 63]):
        assert tde.laplacian_blur_flag(img, box) == jde.laplacian_blur_flag(img, box)


def _aps_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 0.005, (k, got[k], want[k])


def test_official_eval_against_the_jax_tool(tree, tmp_path):
    root, gp, _goldens = tree
    argv = ["--goldens", gp, "--ref-dir", root]
    got = toe.main(argv + ["--work-dir", str(tmp_path / "port"), "--device", "cpu"])
    want = joe.main(argv + ["--work-dir", str(tmp_path / "jax")])
    assert set(got["modes"]) == set(want["modes"]) == {"standard", "sahi"}
    for mode in want["modes"]:
        _aps_close(got["modes"][mode]["aps"], want["modes"][mode]["aps"])
    assert got["modes"]["sahi"]["aps"]["all"] > 0.5
    assert json.load(open(tmp_path / "port" / "summary.json"))["modes"].keys() == got["modes"].keys()


def test_dual_eval_and_tuner_against_the_jax_tool(tree, tmp_path):
    root, gp, _goldens = tree
    argv = ["--goldens", gp, "--ref-dir", root, "--modes", "baseline,sahi", "--tune"]
    got = tde.main(argv + ["--work-dir", str(tmp_path / "port"), "--device", "cpu"])
    want = jde.main(argv + ["--work-dir", str(tmp_path / "jax")])
    assert got["dual"]["statistics"] == want["dual"]["statistics"]
    for mode in ("baseline", "sahi"):
        for key in ("subcategory_results", "difficulty_results"):
            rows, wrows = got["dual"]["modes"][mode][key], want["dual"]["modes"][mode][key]
            assert [r["category"] for r in rows] == [r["category"] for r in wrows]
            for r, w in zip(rows, wrows):
                assert r["total_gt"] == w["total_gt"]
                assert abs(r["ap"] - w["ap"]) <= 0.005, (mode, r["category"], r["ap"], w["ap"])
    t, w = got["tuning"], want["tuning"]
    assert [(r["slice_size"], r["overlap"]) for r in t["results"]] == [(r["slice_size"], r["overlap"]) for r in w["results"]]
    for r, s in zip(t["results"], w["results"]):
        assert r["errors"] == s["errors"] == 0
        assert abs(r["map50"] - s["map50"]) <= 0.005
    assert os.path.exists(tmp_path / "port" / "tuning" / "best_sahi_config.json")


def test_conf_sweep_against_the_jax_tool(tree, tmp_path):
    """The sweep's detections and rows with float32 detectors on both sides
    (the bfloat16 ones move a score near a threshold, and one of 4 held-out
    faces is 0.25 of recall), then the port's main as a user runs it."""
    from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxYolo
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel

    root, gp, goldens = tree
    names = sorted(goldens["images"])
    jdet = JaxYolo(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.05, image_size=640)
    tdet = YoloV11PoseDetectionModel(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.05,
                                     image_size=640, device="cpu")
    got = tcs.collect_detections(tdet, names, goldens, root)
    want = jcs.collect_detections(jdet, names, goldens, root)
    for name in names:
        assert len(got[name]) == len(want[name]) > 0
        np.testing.assert_allclose([d[0] for d in got[name]], [d[0] for d in want[name]], atol=0.05)
        np.testing.assert_allclose([d[1] for d in got[name]], [d[1] for d in want[name]], atol=1e-3)
    for conf in np.arange(0.20, 0.801, 0.025):
        assert tcs.score_split(got, names, goldens, conf) == jcs.score_split(want, names, goldens, conf)

    report = tcs.main(["--goldens", gp, "--ref-dir", root, "--weights", CKPT, "--min-precision", "0.5",
                       "--out", str(tmp_path / "sweep.json"), "--device", "cpu"])
    assert set(report) == {"checkpoint", "protocol", "sweep", "chosen", "full_set_at_chosen"}
    assert len(report["sweep"]) == 25 and report["chosen"] is not None
    assert json.load(open(tmp_path / "sweep.json"))["checkpoint"] == CKPT
