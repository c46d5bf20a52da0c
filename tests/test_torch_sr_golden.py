"""The port's SR golden loop (facedet_tpu_torch/tools/sr_golden_train.py,
tools/sr_cascade_eval.py, eval/iqa_train.main) against the JAX package's on
the CPU, on a synthetic reference tree (utils/synth.synthetic_reference_tree).

Tolerances: the host helpers (the unique-image corpus, the face crops from
one seed, the size rule, the IQA table, the side-by-side JPEG) equal bit for
bit; with a tiny RRDB (tests/test_torch_enhancer.py's config and its
tolerances, the same weights through an .npz) the cascade forwards within
2e-5 on [0, 1], the enhanced crops equal but for values on the other side of
.5 (one level, at most 0.1% of them), the fidelity rows' bicubic PSNR equal
and restored PSNR within 0.01 dB; ``iqa_train.main`` given the same corpus
writes the same two artifacts bit for bit.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.engine import enhancer as jenh
from facedet_tpu.engine.detector import load_params_npz as jax_load_params_npz
from facedet_tpu.engine.detector import save_params_npz
from facedet_tpu.eval import iqa_train as jiqa
from facedet_tpu.models.rrdbnet import RRDBConfig as JaxRRDBConfig
from facedet_tpu.tools import golden_finetune as jgf
from facedet_tpu.tools import sr_cascade_eval as jce
from facedet_tpu.tools import sr_golden_train as jsr
from facedet_tpu_torch.engine import enhancer as tenh
from facedet_tpu_torch.eval import iqa_train as tiqa
from facedet_tpu_torch.models.rrdbnet import RRDBConfig
from facedet_tpu_torch.tools import reference_goldens as trg
from facedet_tpu_torch.tools import sr_cascade_eval as tce
from facedet_tpu_torch.tools import sr_golden_train as tsr
from facedet_tpu_torch.utils.synth import synthetic_reference_tree

torch.set_num_threads(1)

DIMS = dict(num_feat=8, num_block=1, num_grow_ch=4)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reference"))
    synthetic_reference_tree(root, n_images=4, hw=(192, 256), n_faces=4, size=(30, 60), seed=13)
    gp = os.path.join(root, "goldens.json")
    with open(gp, "w") as f:
        json.dump(trg.extract_goldens(root), f)
    return root, gp


@pytest.fixture(scope="module")
def records(tree):
    root, gp = tree
    return tsr.load_unique_golden_images(ref_dir=root, goldens=gp)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX x2 enhancer, port x2 enhancer, .npz path): a tiny RRDB with the
    same perturbed random weights, float32."""
    j = jenh.FaceEnhancer(cfg=JaxRRDBConfig(scale=2, **DIMS), half=False, device="cpu", outscale=2, tile=0)
    rng = np.random.default_rng(2)
    j.variables = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32)), j.variables)
    path = str(tmp_path_factory.mktemp("weights") / "tiny_x2.npz")
    save_params_npz(path, jax.device_get(j.variables))
    t = tenh.FaceEnhancer(cfg=RRDBConfig(scale=2, **DIMS), model_path=path, half=False, device="cpu",
                          outscale=2, tile=0)
    return j, t, path


def test_corpus_crops_table_and_grid_equal_the_jax_helpers(tree, records, monkeypatch, tmp_path):
    root, gp = tree
    monkeypatch.setattr(jgf, "load_golden_dataset", functools.partial(jgf.load_golden_dataset, gp, root))
    want = jsr.load_unique_golden_images()
    assert [r["name"] for r in records] == [r["name"] for r in want] and len(records) == 4
    for a, b in zip(records, want):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
    crops = tsr.collect_face_crops(records, 6, seed=3)
    wcrops = jsr.collect_face_crops(want, 6, seed=3)
    assert len(crops) == len(wcrops) == 6
    for a, b in zip(crops, wcrops):
        assert a["category"] == b["category"] and a["name"] == b["name"]
        np.testing.assert_array_equal(a["crop"], b["crop"])
    for w, h in ((10, 60), (49, 20), (50, 149), (150, 10)):
        assert tsr._size_category(w, h) == jsr._size_category(w, h)
    enhanced = [np.ascontiguousarray(c["crop"][::-1]) for c in crops]
    assert tsr.iqa_table(crops, enhanced) == jsr.iqa_table(wcrops, enhanced)
    a, b = str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")
    tsr.save_side_by_side(crops, enhanced, a)
    jsr.save_side_by_side(wcrops, enhanced, b)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_enhance_crops_and_fidelity_against_jax(records, pair):
    j, t, _path = pair
    crops = [c["crop"] for c in tsr.collect_face_crops(records, 5)]
    got, want = tsr.enhance_crops(t, crops), jsr.enhance_crops(j, crops)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    rows, wrows = tsr.fidelity_eval(t, records[:2], 2), jsr.fidelity_eval(j, records[:2], 2)
    for r, w in zip(rows, wrows):
        assert r["image"] == w["image"] and r["hw"] == w["hw"]
        assert r["psnr_bicubic"] == w["psnr_bicubic"]
        assert abs(r["psnr_restored"] - w["psnr_restored"]) <= 0.01


@pytest.mark.parametrize("arm", ["cascade", "x2resize"])
def test_cascade_forwards_against_jax(pair, arm, monkeypatch):
    j, t, _path = pair
    monkeypatch.setattr(jenh, "FaceEnhancer", lambda *a, **k: j)
    monkeypatch.setattr(tenh, "FaceEnhancer", lambda *a, **k: t)
    jbase, jfwd = jce.make_cascade_forward(arm)
    tbase, tfwd = tce.make_cascade_forward(arm, device="cpu")
    x = np.random.default_rng(4).random((2, 12, 16, 3)).astype(np.float32)
    want = np.asarray(jfwd(jbase.variables, jnp.asarray(x)))
    got = tfwd(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 48, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    crops = [np.ascontiguousarray((x[i] * 255).astype(np.uint8)) for i in range(2)]
    for a, b in zip(tce.enhance_crops_cascade(tbase, tfwd, crops), jce.enhance_crops_cascade(jbase, jfwd, crops)):
        d = np.abs(a.astype(int) - b.astype(int))
        assert a.shape == b.shape and d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_sr_golden_train_and_cascade_mains_run_on_the_tree(tree, pair, tmp_path, monkeypatch):
    root, gp = tree
    report = tsr.main(["--goldens", gp, "--ref-dir", root, "--device", "cpu", "--blocks", "1", "--feat", "8",
                       "--steps", "2", "--staged", "2", "--batch", "2", "--hr-size", "32", "--patches", "8",
                       "--holdout", "1", "--gan-steps", "2", "--gan-percep-weight", "0.1", "--max-crops", "4",
                       "--out", str(tmp_path / "x2.npz"), "--report", str(tmp_path / "sr_report.json")])
    # the JAX tool's report fields, and the port's loss history
    assert set(report) == {"config", "train_seconds", "final_loss", "loss_history", "gan", "fidelity_holdout",
                           "iqa_face_crops", "side_by_side"}
    assert np.isfinite(report["final_loss"]) and set(report["gan"]["final"]) == {"pixel", "adv", "percep", "d"}
    assert report["config"]["holdout_images"] == [report["fidelity_holdout"][0]["image"]]
    assert set(jax_load_params_npz(str(tmp_path / "x2.npz"))) == {"params"}
    assert os.path.exists(report["side_by_side"])

    _j, t, _path = pair
    monkeypatch.setattr(tenh, "FaceEnhancer", lambda *a, **k: t)
    casc = tce.main(["--goldens", gp, "--ref-dir", root, "--device", "cpu", "--max-crops", "3",
                     "--report", str(tmp_path / "casc.json")])
    assert set(casc) == {"arm", "base_checkpoint", "fidelity_holdout", "iqa_face_crops"}
    assert len(casc["fidelity_holdout"]) == 3 and casc["iqa_face_crops"]["overall"]["n"] == 3


def test_iqa_train_main_equals_the_jax_main_on_one_corpus(tree, records, tmp_path, monkeypatch):
    root, gp = tree
    photos = [r["image"] for r in records]
    monkeypatch.setattr(jiqa, "ASSETS_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(jiqa, "real_photo_corpus", lambda: photos)
    want = jiqa.main()
    got = tiqa.main(["--out-dir", str(tmp_path / "port"), "--ref-dir", root, "--goldens", gp])
    assert got["niqe_photos"] == len(photos) == 4
    assert got["rmse"] == want["rmse"] and got["n"] == want["n"]
    for name in ("niqe_pristine.npz", "brisque_svr.npz"):
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_real_photo_corpus_reads_the_goldens_and_fails_loudly(tree, tmp_path):
    root, gp = tree
    photos = tiqa.real_photo_corpus(ref_dir=root, goldens=gp)
    assert len(photos) == 4 and photos[0].dtype == np.uint8
    assert tiqa.real_photo_corpus(ref_dir=str(tmp_path), goldens=gp) == []
    with pytest.raises(FileNotFoundError):
        tiqa.real_photo_corpus(ref_dir=root, goldens=str(tmp_path / "missing.json"))
    broken = tmp_path / "broken"
    os.makedirs(broken / "temp_streamlit" / "0_Synthetic_faces_0")
    (broken / "temp_streamlit" / "0_Synthetic_faces_0" / "temp_sahi_input.jpg").write_bytes(b"not a jpeg")
    with pytest.raises(OSError):  # PIL.UnidentifiedImageError
        tiqa.real_photo_corpus(ref_dir=str(broken), goldens=gp)
