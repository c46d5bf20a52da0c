"""The port's trainers and tools against the JAX package on the CPU:
``YoloDataset`` and ``YoloTrainer`` (train/yolo_trainer.py), the ``.npz``
export (``to_jax_variables`` + ``save_params_npz``), ``checkpoint``,
``tools/training_rollup``, ``tools/misc`` and ``tools/selftrain_demo``.

Tolerances: resized pixels within 1e-5 (``ops/image.resize_chw`` against
``jax.image.resize``), boxes, masks and host arithmetic exactly; the
exported ``last.npz`` through the JAX ``YoloV11`` within 1e-5 of the largest
map value of the port's model; detections of the two trainers' detection
models equal in count, boxes within 0.05 px, scores within 1e-3 (the
detection tolerances of chip_smoke.py); a resumed run equal to an uninterrupted one bit for
bit.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from facedet_tpu.engine.detector import load_params_npz as jax_load_params_npz
from facedet_tpu.engine.fake import FakeBlobDetectionModel as JaxFake
from facedet_tpu.engine.predict import get_prediction as jax_get_prediction
from facedet_tpu.eval.coco_map import coco_map as jax_coco_map
from facedet_tpu.models.yolov11 import YoloConfig as JaxYoloConfig
from facedet_tpu.models.yolov11 import YoloV11 as JaxYoloV11
from facedet_tpu.tools import training_rollup as jax_rollup
from facedet_tpu.train.yolo_trainer import YoloDataset as JaxYoloDataset
from facedet_tpu.train.yolo_trainer import YoloTrainer as JaxYoloTrainer
from facedet_tpu_torch.engine.detector import save_params_npz
from facedet_tpu_torch.engine.fake import FakeBlobDetectionModel
from facedet_tpu_torch.engine.predict import get_prediction
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models.init import random_init
from facedet_tpu_torch.models.rtdetr import RTDETR_VARIANTS, RtDetr
from facedet_tpu_torch.models.scrfd import SCRFD_VARIANTS, Scrfd
from facedet_tpu_torch.models.yolov11 import YoloConfig
from facedet_tpu_torch.tools import misc, selftrain_demo, training_rollup
from facedet_tpu_torch.train import checkpoint as ckpt
from facedet_tpu_torch.train import scrfd_train, yolo_train
from facedet_tpu_torch.train.rtdetr_train import RtDetrTrainer
from facedet_tpu_torch.train.yolo_trainer import YoloDataset, YoloTrainer
from facedet_tpu_torch.utils.synth import synthetic_faces_with_boxes

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "facedet_tpu", "eval", "assets")
YOLO_CKPT = os.path.join(ASSETS, "yolo11n_golden.npz")
SCRFD_CKPT = os.path.join(ASSETS, "scrfd_2_5g_golden.npz")


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Five seeded PNGs of synthetic faces (non-square, two sizes) with YOLO
    labels; one image has no label file."""
    root = tmp_path_factory.mktemp("yolo_ds")
    images, labels = root / "images", root / "labels"
    images.mkdir()
    labels.mkdir()
    for i in range(5):
        h, w = (96, 128) if i % 2 else (120, 90)
        img, boxes = synthetic_faces_with_boxes(h, w, seed=40 + i, n=2, size=(30, 40))
        Image.fromarray(img).save(images / f"img{i}.png")
        if i == 4:
            continue
        rows = [f"0 {(b[0] + b[2]) / 2 / w:.6f} {(b[1] + b[3]) / 2 / h:.6f} {(b[2] - b[0]) / w:.6f} "
                f"{(b[3] - b[1]) / h:.6f}" for b in boxes]
        (labels / f"img{i}.txt").write_text("\n".join(rows) + "\n")
    return str(images), str(labels)


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if got.dtype == np.float32 and what.startswith("image"):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_dataset_load_and_batches_match_jax(dataset_dir, augment):
    kw = dict(image_size=48, max_boxes=6, augment=augment, seed=5)
    jd, td = JaxYoloDataset(*dataset_dir, **kw), YoloDataset(*dataset_dir, **kw)
    assert jd.items == td.items and len(td) == 5
    for name in td.items:
        for j, (g, w) in enumerate(zip(td._load(name), jd._load(name))):
            _same(g, w, f"{('image', 'boxes', 'mask')[j]} of {name}")
    for j, (g, w) in enumerate(zip(td._mosaic([0, 3, 1, 4]), jd._mosaic([0, 3, 1, 4]))):
        _same(g, w, f"{('image', 'boxes', 'mask')[j]} of the mosaic")
    batches = list(zip(td.batches(2, shuffle=True, mosaic_prob=0.5), jd.batches(2, shuffle=True, mosaic_prob=0.5)))
    assert len(batches) == 2
    for b, (got, want) in enumerate(batches):
        for j, (g, w) in enumerate(zip(got, want)):
            assert isinstance(g, torch.Tensor)
            _same(g.numpy(), w, f"{('image', 'boxes', 'mask', 'kpts')[j]} of batch {b}")


def test_hsv_jitter_matches_jax():
    img = np.random.default_rng(1).uniform(0, 1, (20, 30, 3)).astype(np.float32)
    jd = JaxYoloDataset.__new__(JaxYoloDataset)
    td = YoloDataset.__new__(YoloDataset)
    jd.rng, td.rng = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        np.testing.assert_array_equal(td._hsv_jitter(img), jd._hsv_jitter(img))


@pytest.fixture(scope="module")
def trained(dataset_dir, tmp_path_factory):
    """A port trainer from the golden yolo11n, two epochs at 64x64 on the
    dataset (lr 1e-5), and its output directory."""
    out = str(tmp_path_factory.mktemp("run"))
    trainer = YoloTrainer(YoloConfig(scale="n"), lr=1e-5, output_dir=out, patience=5, save_period=1,
                          image_size=64, device="cpu", variables=from_jax.load_params_npz(YOLO_CKPT))
    ds = YoloDataset(*dataset_dir, image_size=64, max_boxes=4)
    result = trainer.fit(lambda epoch: ds.batches(2, shuffle=False), num_epochs=2, verbose=False)
    return trainer, out, result


def test_fit_writes_what_the_jax_trainer_writes(trained):
    trainer, out, result = trained
    assert result["epochs"] == 2 and np.isfinite(result["best_loss"])
    assert sorted(os.listdir(out)) == ["best.npz", "config.json", "epoch1.npz", "epoch2.npz", "last.npz", "results.csv"]
    lines = open(os.path.join(out, "results.csv")).read().splitlines()
    assert lines[0] == "epoch,train_loss" and [ln.split(",")[0] for ln in lines[1:]] == ["0", "1"]
    assert json.load(open(os.path.join(out, "config.json"))) == {"scale": "n", "imgsz": 64, "epochs": 2}
    # the parameters moved: the step is not a no-op past the schedule's count 0
    golden = from_jax.load_params_npz(YOLO_CKPT)
    last = from_jax.load_params_npz(os.path.join(out, "last.npz"))
    moved = jax.tree.map(lambda a, b: float(np.abs(a - b).max()), last["params"], golden["params"])
    assert max(jax.tree.leaves(moved)) > 0


def test_patience_stops_a_run_that_does_not_improve(dataset_dir, tmp_path):
    """At lr 0 every epoch has the same loss: patience 2 stops after three
    epochs of five, as the JAX trainer's rule does."""
    trainer = YoloTrainer(YoloConfig(scale="n"), lr=0.0, output_dir=str(tmp_path), patience=2, save_period=0,
                          image_size=32, device="cpu")
    ds = YoloDataset(*dataset_dir, image_size=32, max_boxes=4)
    result = trainer.fit(lambda epoch: ds.batches(4, shuffle=False), num_epochs=5, verbose=False)
    assert result["epochs"] == 3 and len({h["train_loss"] for h in trainer.history}) == 1
    assert sorted(os.listdir(tmp_path)) == ["best.npz", "config.json", "last.npz", "results.csv"]


def test_exported_npz_loads_into_the_jax_model(trained):
    trainer, out, _ = trained
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = JaxYoloV11(JaxYoloConfig(scale="n"))
    want = jm.apply(jax_load_params_npz(os.path.join(out, "last.npz")), jnp.asarray(x), train=False)
    model = trainer.model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for lw, lg in zip(want, got):
        for k in lw:
            w = np.asarray(lw[k])
            np.testing.assert_allclose(lg[k].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_as_detection_model_detects_what_the_jax_trainers_does(trained):
    trainer, out, _ = trained
    jt = JaxYoloTrainer(JaxYoloConfig(scale="n"), image_size=64, output_dir=out)
    variables = jax_load_params_npz(os.path.join(out, "last.npz"))
    jt.params, jt.batch_stats = variables["params"], variables["batch_stats"]
    image, _ = synthetic_faces_with_boxes(200, 200, seed=3, n=1, size=(90, 99))
    want = jax_get_prediction(image, jt.as_detection_model()).object_prediction_list
    det = trainer.as_detection_model()
    assert det.model is not trainer.model and not det.model.training
    got = get_prediction(image, det).object_prediction_list
    assert len(got) == len(want) > 0
    np.testing.assert_allclose([p.bbox.to_xyxy() for p in got], [p.bbox.to_xyxy() for p in want], atol=0.05)
    np.testing.assert_allclose([p.score.value for p in got], [p.score.value for p in want], atol=1e-3)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        YoloTrainer(YoloConfig(scale="n"), image_size=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        selftrain_demo.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        selftrain_demo.main(["--model", "rtdetr", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RtDetrTrainer(RTDETR_VARIANTS["rtdetr-tiny"], image_size=32)


# --- the .npz interchange -------------------------------------------------------

def _topiq_export():
    """TOPIQ's flax variables (tiny config), and the port's state dict and
    head map after loading them: the packed ``in_proj`` layout."""
    from test_torch_topiq import TINY, flax_variables

    from facedet_tpu.models import topiq as jtopiq
    from facedet_tpu_torch.models import topiq as ttopiq

    tree = flax_variables(jtopiq.TopiqConfig(**TINY))
    model = ttopiq.CFANet(ttopiq.TopiqConfig(**TINY))
    from_jax.load_topiq_variables(model, tree)
    assert any(k.endswith("in_proj_weight") for k in model.state_dict())
    return tree, model.state_dict(), from_jax.attention_heads(model)


@pytest.mark.parametrize("path", [YOLO_CKPT, SCRFD_CKPT, "topiq"], ids=["yolo11n", "scrfd_2.5g", "topiq"])
def test_to_jax_variables_inverts_from_jax(path, tmp_path):
    if path == "topiq":
        tree, state, heads = _topiq_export()
    else:
        tree = from_jax.load_params_npz(path)
        state, heads = from_jax.from_jax_variables(tree), None
    back = from_jax.to_jax_variables(state, heads)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    out = str(tmp_path / "sub" / "w.npz")
    save_params_npz(out, back)
    loaded = jax_load_params_npz(out)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    save_params_npz(str(tmp_path / "half.npz"), back, half=True)
    with np.load(str(tmp_path / "half.npz")) as flat:
        assert all(flat[k].dtype == np.float16 for k in flat.files)


def test_to_jax_variables_raises_on_folded_attention():
    """Without a head map the folded attention projections raise; with the
    module's head map rtdetr-tiny's flax variables (attention kernels
    [D, H, dh] / [H, dh, D], biases [H, dh], the bare ``dn_embed``) come back
    bit for bit."""
    from test_torch_scrfd import seeded_variables

    from facedet_tpu.models import rtdetr as jax_rtdetr

    model = RtDetr(dataclasses.replace(RTDETR_VARIANTS["rtdetr-tiny"]))
    with pytest.raises(NotImplementedError, match="head count"):
        from_jax.to_jax_variables({k: v for k, v in model.state_dict().items() if k != "dn_embed"})
    jm = jax_rtdetr.RtDetr(jax_rtdetr.RTDETR_VARIANTS["rtdetr-tiny"])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    tree = seeded_variables(jax.tree.map(lambda x: np.zeros(x.shape, np.float32), shapes), 3)
    from_jax.load_jax_variables(model, tree)
    heads = from_jax.attention_heads(model)
    assert heads == {"encoder.aifi.self_attn": 4, "layer0.self_attn": 4, "layer1.self_attn": 4}
    back = from_jax.to_jax_variables(model.state_dict(), heads)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# --- checkpoints ----------------------------------------------------------------

def make_state(v):
    return {"params": {"w": torch.full((4, 4), float(v)), "b": torch.zeros(4)}, "step": v}


def test_save_restore_roundtrip(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), make_state(3), step=3)
    assert ckpt.latest_step(str(tmp_path)) == 3
    restored, step = ckpt.restore_checkpoint(str(tmp_path))
    assert step == 3 and float(restored["params"]["w"][0, 0]) == 3.0


def test_latest_of_many(tmp_path):
    for s in (1, 5, 2):
        ckpt.save_checkpoint(str(tmp_path), make_state(s), step=s)
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, step = ckpt.restore_checkpoint(str(tmp_path))
    assert step == 5 and float(restored["params"]["w"][0, 0]) == 5.0
    with pytest.raises(FileExistsError):
        ckpt.save_checkpoint(str(tmp_path), make_state(2), step=2, force=False)


def test_manager_policy_and_resume(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), save_period=2, max_keep=2)
    for step, m in enumerate([1.0, 0.5, 0.7, 0.3]):
        actions = mgr.step_end(make_state(step), step, m)
    assert actions == {"saved_last": True, "saved_best": True, "saved_periodic": True}
    restored, step = mgr.resume()
    assert step == 3 and restored["step"] == 3
    assert ckpt.restore_checkpoint(str(tmp_path / "best"))[1] == 3
    assert sorted(os.listdir(tmp_path / "periodic")) == ["step_1", "step_3"]
    assert os.listdir(tmp_path / "last") == ["step_3"]


def test_resume_empty(tmp_path):
    assert ckpt.CheckpointManager(str(tmp_path)).resume() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path))


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """Two AdamW steps, a checkpoint, a fresh model and optimizer resumed
    from it, a third step: the same weights, moments and rate as three
    steps without the break."""
    cfg = dataclasses.replace(SCRFD_VARIANTS["scrfd_500m"], stem=8, widths=(8, 12, 16, 24), depths=(1, 1, 1, 1),
                              neck=16, head_width=16, dtype="float32")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    boxes = torch.tensor([[[8.0, 8.0, 30.0, 30.0]], [[20.0, 24.0, 50.0, 60.0]]])
    mask = torch.ones((2, 1), dtype=torch.bool)

    def fresh():
        model = Scrfd(cfg)
        random_init(model, 1)
        tx = yolo_train.make_optimizer(model.parameters(), lr=1e-3, warmup_steps=1)
        return model, tx, scrfd_train.make_scrfd_train_step(model, tx)

    ref, ref_tx, ref_step = fresh()
    for _ in range(3):
        ref_step(images, boxes, mask)
    model, tx, step = fresh()
    mgr = ckpt.CheckpointManager(str(tmp_path))
    for i in range(2):
        step(images, boxes, mask)
        mgr.step_end(ckpt.train_state(model, tx, i), i, metric=float(i))
    model, tx, step = fresh()
    state, saved = mgr.resume()
    assert ckpt.load_train_state(model, tx, state) == saved == 1
    step(images, boxes, mask)
    for (name, a), b in zip(model.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(a, b), name
    assert tx.optimizer.param_groups[0]["lr"] == ref_tx.optimizer.param_groups[0]["lr"]


# --- tools ----------------------------------------------------------------------

def test_training_rollup_equals_the_jax_tool(tmp_path):
    runs = tmp_path / "runs"
    for name, csv, cfg in (
        ("exp1", "epoch,train_loss\n0,1.5\n1,0.8\n2,0.9\n", {"imgsz": 640, "epochs": 3}),
        ("exp2/sub", "epoch,map50,map\n0,0.2,0.1\n1,0.6,0.3\n2,0.5,0.35\n", {"batch": 8, "lr": 1e-4}),
    ):
        (runs / name).mkdir(parents=True)
        (runs / name / "results.csv").write_text(csv)
        (runs / name / "config.json").write_text(json.dumps(cfg))
    want = jax_rollup.write_summary(str(runs), str(tmp_path / "jax.csv"))
    got = training_rollup.write_summary(str(runs), str(tmp_path / "port.csv"))
    key = lambda r: r["run"]  # noqa: E731
    assert sorted(got, key=key) == sorted(want, key=key) and len(got) == 2
    assert sorted(open(tmp_path / "port.csv").read().splitlines()) == sorted(open(tmp_path / "jax.csv").read().splitlines())
    assert training_rollup.best_epoch([]) is None


def test_misc_tools(tmp_path):
    info = misc.check_devices()
    assert info == {"backend": "cpu", "num_devices": 0, "devices": []} or info["backend"] == "cuda"
    csv = tmp_path / "results.csv"
    csv.write_text("epoch,train_loss\n0,1.0\n1,0.5\n")
    out = misc.plot_results(str(csv))
    assert out is None or (out.endswith(".png") and os.path.exists(out))
    img = np.zeros((100, 120, 3), np.uint8)
    img[29:32, 39:42] = 255
    dataset = [{"file_name": "a.jpg", "image_id": 1, "gt": [[35, 25, 10, 10]]}]
    kw = dict(use_sahi=True, slice_size=64, perform_standard_pred=False)
    from facedet_tpu.tools.misc import validate_detector as jax_validate

    got = misc.validate_detector(FakeBlobDetectionModel(confidence_threshold=0.5, image_size=64, device="cpu"),
                                 dataset, lambda _: img, **kw)
    want = jax_validate(JaxFake(confidence_threshold=0.5, image_size=64), dataset, lambda _: img, **kw)
    assert got == want and got["map50"] > 0.99


@pytest.mark.parametrize("argv", [["--model", "yolo", "--kpts"], ["--model", "scrfd"]], ids=["yolo-kpts", "scrfd"])
def test_selftrain_demo_runs_on_the_cpu(argv):
    """A few steps at 64x64 on the CPU: it runs, trains, and returns the JAX
    demo's keys (``before``/``after`` as ``coco_map`` returns them, and the
    landmark errors with ``--kpts``)."""
    out = selftrain_demo.main(argv + ["--steps", "3", "--batch", "2", "--size", "64", "--device", "cpu"])
    coco_keys = set(jax_coco_map([], [{"image_id": 0, "bbox": [0, 0, 1, 1]}]))
    want = {"before", "after"} | ({"kpt_px_err_before", "kpt_px_err_after", "kpt_faces_scored"} if "--kpts" in argv else set())
    assert set(out) == want
    assert set(out["before"]) == set(out["after"]) == coco_keys


def test_blob_dataset_is_the_jax_demos():
    from facedet_tpu.tools.selftrain_demo import make_blob_dataset as jax_blobs

    for got, want in zip(selftrain_demo.make_blob_dataset(4, 64, seed=3, with_kpts=True),
                         jax_blobs(4, 64, seed=3, with_kpts=True)):
        np.testing.assert_array_equal(got, want)
