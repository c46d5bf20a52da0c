"""The golden loop's entry points (facedet_tpu_torch/tools/golden_*.py,
reference_goldens.py, sr_golden_train.py, sr_cascade_eval.py,
eval/iqa_train.py) as a user runs them: without a card each raises unless
given ``--device cpu``, and run with their default outputs they write under
``runs/`` and leave the JAX package's committed assets byte for byte as
they were (the JAX tools write their defaults there)."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from facedet_tpu_torch.engine import enhancer
from facedet_tpu_torch.eval import iqa_train
from facedet_tpu_torch.models.rrdbnet import RRDBConfig
from facedet_tpu_torch.tools import (
    golden_conf_sweep,
    golden_dual_eval,
    golden_finetune,
    golden_keypoints,
    golden_official_eval,
    reference_goldens,
    sr_cascade_eval,
    sr_golden_train,
)
from facedet_tpu_torch.utils.synth import synthetic_reference_tree

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "facedet_tpu", "eval", "assets")
CKPT = os.path.join(ASSETS, "yolo11n_golden.npz")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reference"))
    synthetic_reference_tree(root, n_images=4, hw=(96, 128), n_faces=2, size=(24, 40), seed=17)
    gp = os.path.join(root, "goldens.json")
    with open(gp, "w") as f:
        json.dump(reference_goldens.extract_goldens(root), f)
    return root, gp


def _runs(root, gp):
    """(name, main, argv without --device) of every entry point."""
    data = ["--goldens", gp, "--ref-dir", root]
    sr = ["--blocks", "1", "--feat", "8", "--steps", "1", "--staged", "1", "--batch", "2", "--hr-size", "32",
          "--patches", "4", "--holdout", "1", "--max-crops", "2"]
    return [
        ("golden_finetune", golden_finetune.main, data + ["--steps", "1", "--size", "64", "--batch", "2"]),
        ("golden_official_eval", golden_official_eval.main, data + ["--modes", "standard"]),
        ("golden_dual_eval", golden_dual_eval.main, data + ["--modes", "baseline"]),
        ("golden_conf_sweep", golden_conf_sweep.main, data + ["--confs", "0.3,0.5"]),
        ("sr_golden_train", sr_golden_train.main, data + sr),
        ("sr_cascade_eval", sr_cascade_eval.main, data + ["--max-crops", "1"]),
    ]


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    root, gp = tree
    for _name, main, argv in _runs(root, gp):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden_finetune.main(["--model", "rtdetr", "--variant", "rtdetr-tiny", "--goldens", gp, "--ref-dir", root])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden_finetune.teacher_label_crops(np.zeros((1, 64, 64, 3), np.uint8), CKPT, 0.3, 8)


def _digest(path: str) -> dict:
    return {n: hashlib.sha256(open(os.path.join(path, n), "rb").read()).hexdigest() for n in sorted(os.listdir(path))}


def test_tools_with_default_outputs_leave_the_jax_assets_alone(tree, tmp_path, monkeypatch):
    root, gp = tree
    before = _digest(ASSETS)
    monkeypatch.chdir(tmp_path)
    # the cascade's full-width x2plus takes minutes on a CPU: a narrow net
    # of the same catalog name stands in
    real = enhancer.FaceEnhancer
    monkeypatch.setattr(enhancer, "FaceEnhancer", lambda *a, **k: real(
        *a, **{**k, "cfg": RRDBConfig(scale=2, num_feat=8, num_block=1, num_grow_ch=4), "model_path": None}))
    reference_goldens.main(["--ref-dir", root, "--out", "goldens.json"])
    golden_keypoints.main(["--goldens", gp, "--ref-dir", root])
    for _name, main, argv in _runs(root, gp):
        main(argv + ["--device", "cpu"])
    iqa_train.main([])
    assert _digest(ASSETS) == before
    assert sorted(os.listdir(tmp_path / "runs")) == sorted(
        ["golden_keypoints", "golden_finetune", "golden_official_eval", "golden_dual_eval", "golden_conf_sweep",
         "sr_golden_train", "sr_cascade_eval", "iqa_train"])
