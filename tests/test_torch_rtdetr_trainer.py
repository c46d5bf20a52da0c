"""The port's ``RtDetrTrainer`` (facedet_tpu_torch/train/rtdetr_train.py) and
``selftrain_demo --model rtdetr`` on the CPU.

Tolerances: the exported ``last.npz`` through the JAX package's
``RtDetrDetectionModel`` against the trainer's in-memory model: equal keep
masks, scores within 1e-3, boxes within 0.05 px (the detection tolerances
of tests/test_torch_rtdetr.py); the files and the rollup exactly.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.engine.rtdetr_wrapper import RtDetrDetectionModel as JaxRtDetrModel
from facedet_tpu_torch.models.rtdetr import RTDETR_VARIANTS
from facedet_tpu_torch.tools import selftrain_demo
from facedet_tpu_torch.train.rtdetr_train import RtDetrTrainer, WarmupConstant, xyxy_to_cxcywh
from facedet_tpu_torch.train.yolo_train import WarmupCosineDecay

torch.set_num_threads(1)

SIZE = 64


def _blob_batches(n=4, batch=2, seed=0):
    """The demo's blob images with normalised cxcywh GT, in batches."""
    images, boxes, masks = (torch.from_numpy(a) for a in selftrain_demo.make_blob_dataset(n, SIZE, seed=seed))
    cxcywh = xyxy_to_cxcywh(boxes.float(), float(SIZE))
    return [tuple(a[i:i + batch] for a in (images, cxcywh, masks)) for i in range(0, n, batch)]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("rtdetr_run"))
    trainer = RtDetrTrainer(RTDETR_VARIANTS["rtdetr-tiny"], lr=1e-3, output_dir=out, save_period=1,
                            image_size=SIZE, warmup_steps=1, device="cpu")
    batches = _blob_batches()
    result = trainer.fit(lambda epoch: batches, num_epochs=2, verbose=False)
    return trainer, out, result


def test_fit_writes_what_the_jax_trainer_writes(trained):
    trainer, out, result = trained
    assert result["epochs"] == 2 and np.isfinite(result["best_loss"])
    assert sorted(os.listdir(out)) == ["best.npz", "epoch1.npz", "epoch2.npz", "last.npz", "results.csv", "results.json"]
    history = json.load(open(os.path.join(out, "results.json")))
    assert [h["epoch"] for h in history] == [0, 1] and history == trainer.history
    lines = open(os.path.join(out, "results.csv")).read().splitlines()
    assert lines == ["epoch,train_loss"] + [f"{h['epoch']},{h['train_loss']:.6f}" for h in history]
    assert isinstance(trainer.tx.scheduler.lr_lambdas[0], WarmupConstant)
    cos = RtDetrTrainer(RTDETR_VARIANTS["rtdetr-tiny"], output_dir=out, total_steps=500, device="cpu")
    assert isinstance(cos.tx.scheduler.lr_lambdas[0], WarmupCosineDecay) and cos.tx.max_norm == 0.1


def test_last_npz_loads_in_the_jax_rtdetr_and_detects_what_the_trainer_does(trained):
    trainer, out, _ = trained
    kw = dict(variant="rtdetr-tiny", dtype="float32", confidence_threshold=0.05, image_size=SIZE)
    jm = JaxRtDetrModel(model_path=os.path.join(out, "last.npz"), **kw)
    tiles = np.stack([b[0][0].numpy() for b in _blob_batches(seed=5)])
    want = jm.tile_forward(jm.variables, jnp.asarray(tiles), 0.05)
    det = trainer.as_detection_model(confidence_threshold=0.05)
    assert det.model is not trainer.model and not det.model.training
    got = det.forward_tiles(torch.from_numpy(tiles), 0.05)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.valid.sum()) > 0
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-3)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=0.05)


def test_selftrain_demo_rtdetr_runs_on_the_cpu():
    out = selftrain_demo.main(["--model", "rtdetr", "--device", "cpu", "--steps", "3", "--size", str(SIZE),
                               "--batch", "2", "--dn-groups", "2"])
    assert set(out) == {"before", "after", "losses"} and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"])) and 0.0 <= out["after"]["map50"] <= 1.0
