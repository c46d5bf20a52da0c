"""The port's golden fine-tune ``main_cv``, RT-DETR arm and teacher
(facedet_tpu_torch/tools/golden_finetune.py) against
facedet_tpu/tools/golden_finetune.py on the CPU.

Tolerances, stated per check:
  * ``main_cv`` with the training replaced in both packages by the golden
    yolo11n (float32) scored at the eval points: the reports equal but for
    the seconds and paths; the port's own run, trained, writes the same keys
    and a checkpoint both packages load;
  * ``teacher_label_crops``: the same masks, boxes within 0.05 px (PERF.md
    §2's box gate, float32 both);
  * ``--model rtdetr`` (rtdetr-tiny, the golden yolo11n as teacher) runs
    end to end; its checkpoint loads in both packages.
"""
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxYolo
from facedet_tpu.engine.detector import load_params_npz as jax_load_params_npz
from facedet_tpu.tools import golden_finetune as jgf
from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
from facedet_tpu_torch.tools import golden_finetune as tgf
from facedet_tpu_torch.tools import reference_goldens as trg
from facedet_tpu_torch.utils.synth import synthetic_reference_tree

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reference"))
    synthetic_reference_tree(root, n_images=4, hw=(256, 384), n_faces=5, size=(30, 70), seed=9)
    gp = os.path.join(root, "goldens.json")
    with open(gp, "w") as f:
        json.dump(trg.extract_goldens(root), f)
    return root, gp


def _args(**kw):
    base = dict(model="yolo", scale="n", size=64, steps=2, lr=2e-3, batch=2, staged=0, steps_per_dispatch=1,
                mosaic_prob=0.4, no_jitter=False, ema=0.0, scale_range_t=(0.6, 1.6), device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


def _fake_training(package):
    """train_yolo replaced by the golden yolo11n (float32), scored at the
    eval points the real one would reach."""
    def train(args, recs, seed=0, eval_points=(), eval_hook=None, **_kw):
        if package == "jax":
            det = JaxYolo(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.25, image_size=640)
        else:
            det = YoloV11PoseDetectionModel(model_path=CKPT, scale="n", dtype="float32",
                                            confidence_threshold=0.25, image_size=640, device="cpu")
            det.train_state = det.model.state_dict()
        for e in sorted({int(e) for e in eval_points if 0 < int(e) <= args.steps}):
            eval_hook(e, det)
        return det, 0.0
    return train


def _strip(report):
    report = json.loads(json.dumps(report))
    report.pop("final_checkpoint")
    report.pop("final_train_seconds")
    for row in report["folds"]:
        row.pop("train_seconds")
    return report


def test_main_cv_against_the_jax_main_cv(tree, tmp_path, monkeypatch):
    root, gp = tree
    goldens = json.load(open(gp))
    reports = {}
    for package, mod in (("jax", jgf), ("port", tgf)):
        monkeypatch.setattr(mod, "train_yolo", _fake_training(package))
        args = _args(cv=2, steps=4, eval_points_t=None, ref_dir=root, conf=0.35, iou=0.5,
                     out_dir=str(tmp_path / package), variant="rtdetr-m")
        reports[package] = mod.main_cv(args, mod.load_golden_dataset(gp, root), goldens, None)
    assert _strip(reports["port"]) == _strip(reports["jax"])
    assert reports["port"]["final_all_data_parity"]["recall"] > 0.5
    monkeypatch.undo()

    got = tgf.main(["--cv", "2", "--steps", "2", "--size", "64", "--batch", "2", "--goldens", gp,
                    "--ref-dir", root, "--out-dir", str(tmp_path / "trained"), "--device", "cpu"])
    assert set(got) == set(reports["jax"])
    assert [f["fold"] for f in got["folds"]] == [0, 1]
    assert jax.tree.map(np.shape, jax_load_params_npz(got["final_checkpoint"])) == \
        jax.tree.map(np.shape, jax_load_params_npz(CKPT))
    assert os.path.exists(str(tmp_path / "trained" / "cv_report.json"))


def test_teacher_labels_equal_the_jax_teachers(tree):
    root, gp = tree
    records = tgf.load_golden_dataset(gp, root)
    ims = tgf.sample_batch(records, np.random.default_rng(2), 3, out=96, max_boxes=8)[0]
    got = tgf.teacher_label_crops(ims, CKPT, 0.05, 8, fwd_batch=2, device="cpu")
    want = jgf.teacher_label_crops(ims, CKPT, 0.05, 8, fwd_batch=2)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].any()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=0.05)


def test_rtdetr_arm_runs_and_its_checkpoint_loads(tree, tmp_path):
    root, gp = tree
    report = tgf.main(["--model", "rtdetr", "--variant", "rtdetr-tiny", "--size", "64", "--batch", "2",
                       "--staged", "2", "--steps", "2", "--steps-per-dispatch", "1", "--teacher", CKPT,
                       "--teacher-conf", "0.05", "--goldens", gp, "--ref-dir", root,
                       "--out-dir", str(tmp_path), "--device", "cpu"])
    # the JAX main_rtdetr's report keys, and the port's loss history
    assert set(report) == {"model", "steps", "train_seconds", "checkpoint", "train_split", "held_out_split",
                           "loss_history"}
    assert [h[0] for h in report["loss_history"]] == [1, 2]
    assert all(np.isfinite(h[1]) for h in report["loss_history"])
    assert "params" in jax_load_params_npz(report["checkpoint"])
    from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel

    det = RtDetrDetectionModel(model_path=report["checkpoint"], variant="rtdetr-tiny", dtype="float32",
                               image_size=64, device="cpu")
    assert det.model is not None
