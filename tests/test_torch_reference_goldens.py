"""The port's golden recovery (facedet_tpu_torch/tools/reference_goldens.py,
tools/golden_keypoints.py) against the JAX package's on a synthetic
reference tree (utils/synth.synthetic_reference_tree: the reference's
artifact layout with known boxes, confidences and landmark dots).

Tolerances: the goldens JSON and the keypoints JSON equal the JAX tools'
byte for byte; every face recovered at its exact integer box (IoU 1) and
its exact confidence; every drawn landmark within 3 px (0.3 px measured).
"""
import json

import numpy as np
import pytest

from facedet_tpu.tools import golden_keypoints as jgk
from facedet_tpu.tools import reference_goldens as jrg
from facedet_tpu_torch.tools import golden_keypoints as tgk
from facedet_tpu_torch.tools import reference_goldens as trg
from facedet_tpu_torch.utils.synth import synthetic_reference_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reference"))
    truth = synthetic_reference_tree(root, n_images=3, hw=(256, 384), n_faces=5, size=(30, 70), seed=3)
    return root, truth


@pytest.fixture(scope="module")
def goldens(tree):
    return trg.extract_goldens(tree[0])


def test_goldens_json_equals_the_jax_tools(tree, goldens):
    want = jrg.extract_goldens(tree[0])
    assert json.dumps(goldens, indent=1) == json.dumps(want, indent=1)


def test_every_face_is_recovered_at_its_box_and_confidence(tree, goldens):
    _root, truth = tree
    assert sorted(goldens["images"]) == sorted(truth)
    for key, rec in goldens["images"].items():
        assert rec["skipped_crops"] == 0
        faces = sorted(rec["faces"], key=lambda f: f["face_index"])
        assert [f["face_index"] for f in faces] == list(range(len(truth[key]["boxes"])))
        for f in faces:
            i = f["face_index"]
            assert f["bbox"] == truth[key]["boxes"][i].tolist()
            assert f["conf_lo"] == f["conf_hi"] == truth[key]["conf"][i]
            assert f["ncc"] >= 0.85


def test_keypoints_equal_the_jax_tools_and_the_drawn_dots(tree, goldens):
    root, truth = tree
    got = tgk.recover_all(goldens, root)
    assert json.dumps(got, indent=1) == json.dumps(jgk.recover_all(goldens, root), indent=1)
    assert got["n_keypoints_recovered"] == 5 * got["n_faces"] == 5 * sum(len(t["boxes"]) for t in truth.values())
    for key, rec in got["images"].items():
        for f in rec["faces"]:
            k = np.asarray(f["kpts"])
            assert (k[:, 2] == 1).all()
            np.testing.assert_allclose(k[:, :2], truth[key]["kpts"][f["face_index"]], atol=3)


def test_parse_and_locate_match_jax():
    for name in ("a_face_3_conf_0.77.jpg", "x_face_12_conf_1.00.PNG", "detail.jpg", "b_face_1_conf_.5.jpeg"):
        assert trg.parse_crop_name(name) == jrg.parse_crop_name(name)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)
    crop = img[10:30, 25:51]
    assert trg.locate_crop(img, crop) == jrg.locate_crop(img, crop)
    assert trg.locate_crop(img, crop)[:2] == (25, 10)
    assert trg.locate_crop(crop, img) is None


def test_mains_write_where_they_are_told(tree, goldens, tmp_path):
    root, _truth = tree
    out = tmp_path / "goldens.json"
    trg.main(["--ref-dir", root, "--out", str(out)])
    assert json.load(open(out)) == json.loads(json.dumps(goldens))
    kp = tmp_path / "kp" / "golden_keypoints.json"
    tgk.main(["--goldens", str(out), "--ref-dir", root, "--out", str(kp)])
    assert json.load(open(kp))["n_faces"] == sum(len(g["faces"]) for g in goldens["images"].values())
