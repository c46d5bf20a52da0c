"""The port's golden fine-tune (facedet_tpu_torch/tools/golden_finetune.py)
against facedet_tpu/tools/golden_finetune.py on the CPU, on a synthetic
reference tree (utils/synth.synthetic_reference_tree) and its recovered
goldens.

Tolerances, stated per check:
  * the host samplers (crop, mosaic, jitter, batch, split, folds, the blob
    batches) from one ``np.random.default_rng``: equal bit for bit;
  * the EMA update: equal bit for bit to ``jax.tree.map``'s;
  * ``train_yolo``, 2 per-step steps of yolo11n-pose at 128x128, batch 2,
    float32, from JAX's own init carried across by models/from_jax.py, on
    the same batches: the first step's loss parts within 1e-4 relative
    (phase 24's gate, PERF.md §2). AdamW's first update is
    ``lr * g / (|g| + 1e-8)``, the sign of g for all but the smallest: an
    element whose gradient lies within the two frameworks' rounding
    (phase 24 holds gradients to 1e-3 of their leaf's largest) moves the
    other way, by 2 * lr. So after it the second step's parts within 1e-2
    relative, the running statistics within 1e-3, every parameter within
    4 * lr of JAX's (two such steps) and at most 1% of the elements more
    than lr / 2 apart;
  * ``main`` end to end beside the JAX ``main`` on the tree: the report's
    keys (the port adds ``loss_history``), its splits image by image and
    their golden counts equal; each package loads the other's checkpoint.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from facedet_tpu.engine.detector import load_params_npz as jax_load_params_npz
from facedet_tpu.tools import golden_finetune as jgf
from facedet_tpu.train import yolo_train as jyt
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.tools import golden_finetune as tgf
from facedet_tpu_torch.tools import reference_goldens as trg
from facedet_tpu_torch.train import yolo_train as tyt
from facedet_tpu_torch.utils.synth import synthetic_reference_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(root, goldens path, keypoints path) of a 4-image tree (3 train, 1
    held out)."""
    root = str(tmp_path_factory.mktemp("reference"))
    synthetic_reference_tree(root, n_images=4, hw=(256, 384), n_faces=5, size=(30, 70), seed=5)
    gp = os.path.join(root, "goldens.json")
    goldens = trg.extract_goldens(root)
    with open(gp, "w") as f:
        json.dump(goldens, f)
    kp = os.path.join(root, "keypoints.json")
    from facedet_tpu_torch.tools.golden_keypoints import recover_all

    with open(kp, "w") as f:
        json.dump(recover_all(goldens, root), f)
    return root, gp, kp


@pytest.fixture(scope="module")
def records(tree):
    root, gp, kp = tree
    return tgf.load_golden_dataset(gp, root, kp)


def test_dataset_loads_as_the_jax_tool(tree, records):
    root, gp, kp = tree
    want = jgf.load_golden_dataset(gp, root, kp)
    assert [r["name"] for r in records] == [r["name"] for r in want]
    for a, b in zip(records, want):
        for k in ("image", "boxes", "kpts"):
            np.testing.assert_array_equal(a[k], b[k])
    assert any(r["kpts"][..., 2].any() for r in records)


@pytest.mark.parametrize("mosaic_prob,jitter,scale_range", [(0.0, False, (0.6, 1.6)), (0.5, True, (0.8, 2.4))])
def test_sample_batch_bit_for_bit(records, mosaic_prob, jitter, scale_range):
    got = tgf.sample_batch(records, np.random.default_rng(7), 5, out=96, max_boxes=8,
                           mosaic_prob=mosaic_prob, jitter=jitter, scale_range=scale_range)
    want = jgf.sample_batch(records, np.random.default_rng(7), 5, out=96, max_boxes=8,
                            mosaic_prob=mosaic_prob, jitter=jitter, scale_range=scale_range)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2].any()


def test_crop_mosaic_remap_split_and_folds(records):
    rec = records[0]
    for seed in range(3):
        for a, b in zip(tgf.sample_crop(rec, np.random.default_rng(seed), out=64, max_boxes=4),
                        jgf.sample_crop(rec, np.random.default_rng(seed), out=64, max_boxes=4)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tgf.sample_mosaic(records, np.random.default_rng(seed), 64, 6),
                        jgf.sample_mosaic(records, np.random.default_rng(seed), 64, 6)):
            np.testing.assert_array_equal(a, b)
    img = records[1]["image"][:40, :40]
    np.testing.assert_array_equal(tgf._photometric_jitter(img, np.random.default_rng(1)),
                                  jgf._photometric_jitter(img, np.random.default_rng(1)))
    boxes = np.array([[90.0, 90.0, 130.0, 130.0], [10.0, 10.0, 40.0, 40.0]], np.float32)
    for a, b in zip(tgf._remap_boxes(boxes, 5, 0, 100, 50, kpts=np.ones((2, 5, 3), np.float32)),
                    jgf._remap_boxes(boxes, 5, 0, 100, 50, kpts=np.ones((2, 5, 3), np.float32))):
        np.testing.assert_array_equal(a, b)
    names = lambda parts: [[r["name"] for r in p] for p in parts]  # noqa: E731
    assert names(tgf.split_records(records)) == names(jgf.split_records(records))
    for k in (2, 3):
        assert [names(f) for f in tgf.cv_folds(records, k)] == [names(f) for f in jgf.cv_folds(records, k)]
    for a, b in zip(tgf.make_dense_blob_batches(2, 2, 80, 6, np.random.default_rng(11)),
                    jgf.make_dense_blob_batches(2, 2, 80, 6, np.random.default_rng(11))):
        np.testing.assert_array_equal(a, b)
    xyxy = np.array([[[4.0, 6.0, 20.0, 30.0]]], np.float32)
    np.testing.assert_array_equal(tgf._xyxy_to_norm_cxcywh(xyxy, 48.0), jgf._xyxy_to_norm_cxcywh(xyxy, 48.0))


@pytest.mark.parametrize("dd", [min(0.999**100, 3 / 12), min(0.9997, 5 / 14), 0.9997])
def test_ema_update_is_jax_tree_map_bit_for_bit(dd):
    rng = np.random.default_rng(0)
    e, p = (rng.standard_normal((2, 37, 5)).astype(np.float32) for _ in range(2))
    want = jax.tree.map(lambda a, b: a * dd + b * (1 - dd), [jax.numpy.asarray(e)], [jax.numpy.asarray(p)])[0]
    shadow = [torch.from_numpy(e.copy())]
    tgf._ema_update_(shadow, [torch.from_numpy(p)], dd)
    np.testing.assert_array_equal(shadow[0].numpy(), np.asarray(want))


def _recording(module, name, calls):
    """Wrap ``module.name`` (a step factory) so each step call appends
    (inputs, outputs) to ``calls`` as numpy trees."""
    real = getattr(module, name)

    def factory(*a, **k):
        step = real(*a, **k)

        def wrapped(*args):
            inputs = jax.tree.map(np.asarray, args[:2]) if module is jyt else None
            out = step(*args)
            calls.append((inputs, out))
            return out

        return wrapped

    return factory


ARGV = ["--steps", "2", "--size", "128", "--batch", "2", "--conf", "0.05"]


@pytest.fixture(scope="module")
def jax_main(tree, tmp_path_factory):
    """The JAX ``main`` on the tree, with its train step recorded."""
    root, gp, kp = tree
    out = str(tmp_path_factory.mktemp("jax_main"))
    calls = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jyt, "make_train_step", _recording(jyt, "make_train_step", calls))
    try:
        report = jgf.main(ARGV + ["--goldens", gp, "--ref-dir", root, "--out-dir", out])
    finally:
        mp.undo()
    return report, calls


@pytest.fixture(scope="module")
def port_main(tree, tmp_path_factory):
    root, gp, kp = tree
    out = str(tmp_path_factory.mktemp("port_main"))
    return tgf.main(ARGV + ["--goldens", gp, "--ref-dir", root, "--out-dir", out, "--device", "cpu"])


def test_train_yolo_from_jax_init_within_phase_24_gates(tree, records, jax_main, monkeypatch):
    _report, calls = jax_main
    init_params, init_stats = calls[0][0]
    variables = {"params": init_params, "batch_stats": init_stats}
    port_calls = []
    monkeypatch.setattr(tyt, "make_train_step", _recording(tyt, "make_train_step", port_calls))
    args = tgf._parser().parse_args(ARGV + ["--device", "cpu"])
    args.lr, args.scale_range_t = 2e-3, (0.6, 1.6)
    root, gp, _kp = tree
    # the JAX main reads the committed keypoints, which name no synthetic image
    train, _held = tgf.split_records(tgf.load_golden_dataset(gp, root))
    history = []
    det, _s = tgf.train_yolo(args, train, variables=variables, history=history)
    assert [h[0] for h in history] == [0, 1]
    assert len(port_calls) == len(calls) == 2
    for i, ((_, (_p, _b, _o, want_loss, want_parts)), (_, (loss, parts))) in enumerate(zip(calls, port_calls)):
        rtol = 1e-4 if i == 0 else 1e-2
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=rtol, err_msg=f"step {i}")
        for k, v in want_parts.items():
            np.testing.assert_allclose(float(parts[k]), float(v), rtol=rtol, atol=1e-7, err_msg=f"step {i} {k}")
    final_params, final_stats = calls[-1][1][0], calls[-1][1][1]
    want = from_jax.from_jax_variables(jax.tree.map(np.asarray, {"params": final_params, "batch_stats": final_stats}))
    got = det.train_state
    moved = total = 0
    for name, v in want.items():
        if "running" in name:
            np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=1e-3, atol=1e-3, err_msg=name)
        elif v.is_floating_point():
            diff = (got[name] - v).abs()
            assert float(diff.max()) <= 4 * args.lr * (1 + 1e-3), name
            moved += int((diff > args.lr / 2).sum())
            total += v.numel()
    assert moved <= 0.01 * total, (moved, total)


def test_main_report_and_checkpoint_against_the_jax_main(jax_main, port_main):
    want, _calls = jax_main
    got = port_main
    assert set(got) == set(want) | {"loss_history"}
    assert [h[0] for h in got["loss_history"]] == [0, 1]
    assert got["steps"] == want["steps"] == 2
    for split in ("train_split", "held_out_split"):
        assert sorted(got[split]["images"]) == sorted(want[split]["images"])
        for name, row in want[split]["images"].items():
            assert got[split]["images"][name]["golden_faces"] == row["golden_faces"]
        assert set(got[split]) == set(want[split])
    # each package loads the other's checkpoint, the same tree of shapes
    mine, theirs = jax_load_params_npz(got["checkpoint"]), jax_load_params_npz(want["checkpoint"])
    assert jax.tree.map(np.shape, mine) == jax.tree.map(np.shape, theirs)
    state = from_jax.from_jax_variables(from_jax.load_params_npz(want["checkpoint"]))
    assert set(state) == set(from_jax.from_jax_variables(from_jax.load_params_npz(got["checkpoint"])))
    assert os.path.basename(got["checkpoint"]) == os.path.basename(want["checkpoint"]) == "yolo11n_golden.npz"
