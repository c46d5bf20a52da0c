"""The RT-DETR arm of the port's golden fine-tune
(facedet_tpu_torch/tools/golden_finetune.main_rtdetr, ``--model rtdetr``)
against facedet_tpu/tools/golden_finetune.main_rtdetr on the CPU, on a
synthetic reference tree: one dense-blob pretrain dispatch, then one
fine-tune dispatch, of rtdetr-tiny at 128x128, batch 2, contrastive
denoising in 3 groups (the blobs need 128: they reach 94 px).

Both start from one seeded variable tree (tests/test_torch_scrfd.seeded_variables:
flax's own init leaves the encoder scores too close for a stable query
selection) and the port takes the JAX loop's flip and CDN draws from the
keys the JAX tool hands its loop. Tolerances, stated per check:
  * the optimizer (clip 0.1, AdamW weight decay 1e-4) equal to the JAX
    tool's, and its schedule (warmup over a tenth of pretrain + fine-tune
    steps, cosine to lr * 0.05) within float32 rounding (1e-6 of its peak);
  * the staged pretrain and fine-tune data (uint8 images, normalised
    cxcywh boxes, masks) and each dispatch's start equal bit for bit;
  * the first dispatch's loss within 1e-4 relative (phase 24's gate), the
    second within 1e-2 (after AdamW's first update, ``lr * sign(g)`` but
    for gradients within rounding of 0, which move either way);
  * the parameters after the two steps within 4 * lr of JAX's, and at most
    1% of the elements more than lr / 2 apart (phase 24's gates after two
    steps);
  * the report's keys (the port adds ``loss_history``) and its splits'
    images and golden counts equal; each package reads the other's
    checkpoint, the same tree of shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.engine.detector import load_params_npz as jax_load_params_npz
from facedet_tpu.models.rtdetr import RTDETR_VARIANTS, RtDetr
from facedet_tpu.tools import golden_finetune as jgf
from facedet_tpu.train import rtdetr_train as jrt
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models import init as tinit
from facedet_tpu_torch.train import rtdetr_train as trt
from facedet_tpu_torch.tools import golden_finetune as tgf
from test_torch_golden_finetune_staged import (
    record_clipped_adamw, record_optax, same_optimizers,
    tree,  # noqa: F401  (the fixture)
)
from test_torch_rtdetr_train import jax_cdn_draws
from test_torch_scrfd import seeded_variables

torch.set_num_threads(1)

VARIANT, SIZE, BATCH, GROUPS = "rtdetr-tiny", 128, 2, 3
LR = 4e-4  # the tool's default for DETRs


@pytest.fixture(scope="module")
def seeded():
    shapes = jax.eval_shape(
        lambda: RtDetr(RTDETR_VARIANTS[VARIANT]).init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                                                      train=False))
    return seeded_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), 30, gain=1.0)


def _argv(root, gp, out):
    return ["--model", "rtdetr", "--variant", VARIANT, "--size", str(SIZE), "--batch", str(BATCH), "--staged", "2",
            "--pretrain-steps", "1", "--steps", "1", "--steps-per-dispatch", "1", "--dn-groups", str(GROUPS),
            "--max-parity-images", "1", "--goldens", gp, "--ref-dir", root, "--out-dir", out]


def _jax_recorder(calls, seeded):
    """Wrap JAX's ``make_staged_rtdetr_loop``: the first dispatch starts from
    ``seeded``; each dispatch records its staged data, start and key, its
    mean loss and its output params."""
    real = jrt.make_staged_rtdetr_loop

    def factory(*a, **k):
        run = real(*a, **k)

        def wrapped(params, stats, opt, ims, bxs, mks, start, key):
            if not calls:
                params, stats = seeded["params"], seeded["batch_stats"]
            out = run(params, stats, opt, ims, bxs, mks, start, key)
            calls.append({"data": [np.asarray(x) for x in (ims, bxs, mks)], "start": int(start), "key": key,
                          "loss": float(out[-1]), "params": jax.tree.map(np.asarray, out[0])})
            return out

        return wrapped

    return factory


def _port_recorder(calls, seen):
    """Wrap the port's ``make_staged_rtdetr_loop``: dispatch j takes JAX's
    draws from the key JAX's dispatch j got, and records its staged data,
    start and parameters after it."""
    real = trt.make_staged_rtdetr_loop

    def factory(model, tx, steps_per_dispatch, dn_groups, **k):
        run = real(model, tx, steps_per_dispatch=steps_per_dispatch, dn_groups=dn_groups, **k)

        def wrapped(ims, bxs, mks, start=0):
            flips, parts, signs = [], [], []
            for i in range(steps_per_dispatch):
                kf, kc = jax.random.split(jax.random.fold_in(calls[len(seen)]["key"], i))
                flips.append(np.asarray(jax.random.bernoulli(kf, shape=(ims.shape[1],))))
                part, sign = jax_cdn_draws(kc, ims.shape[1], dn_groups, mks.shape[2])
                parts.append(part)
                signs.append(sign)
            loss = run(ims, bxs, mks, start=start, flips=np.stack(flips), parts=torch.from_numpy(np.stack(parts)),
                       signs=torch.from_numpy(np.stack(signs)))
            seen.append({"data": [x.numpy() for x in (ims, bxs, mks)], "start": start, "loss": float(loss),
                         "params": {n: p.detach().clone() for n, p in model.named_parameters()}})
            return loss

        return wrapped

    return factory


def test_rtdetr_arm_against_the_jax_arm(tree, seeded, tmp_path, monkeypatch):
    root, gp = tree
    calls, seen, jax_opts, port_opts = [], [], [], []
    record_optax(monkeypatch, jax_opts)
    record_clipped_adamw(monkeypatch, port_opts)
    monkeypatch.setattr(jrt, "make_staged_rtdetr_loop", _jax_recorder(calls, seeded))
    want = jgf.main(_argv(root, gp, str(tmp_path / "jax")))
    assert len(calls) == 2
    monkeypatch.setattr(trt, "make_staged_rtdetr_loop", _port_recorder(calls, seen))
    monkeypatch.setattr(tinit, "random_init", lambda model, seed: from_jax.load_jax_variables(model, seeded))
    got = tgf.main(_argv(root, gp, str(tmp_path / "port")) + ["--device", "cpu"])
    assert len(seen) == 2

    same_optimizers(port_opts, jax_opts, range(4))
    for c, s in zip(calls, seen):
        assert s["start"] == c["start"] == 0
        for a, b in zip(s["data"], c["data"]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(seen[0]["data"][0], seen[1]["data"][0])  # the blobs, then the crops
    assert got["loss_history"] == [(1, seen[1]["loss"], got["loss_history"][0][2])]
    np.testing.assert_allclose(seen[0]["loss"], calls[0]["loss"], rtol=1e-4)
    np.testing.assert_allclose(seen[1]["loss"], calls[1]["loss"], rtol=1e-2)
    moved = total = 0
    last = from_jax.from_jax_variables({"params": calls[1]["params"]})
    for name, p in seen[1]["params"].items():
        diff = (p - last[name]).abs()
        assert float(diff.max()) <= 4 * LR * (1 + 1e-3), name
        moved += int((diff > LR / 2).sum())
        total += p.numel()
    assert moved <= 0.01 * total, (moved, total)

    assert set(got) == set(want) | {"loss_history"}
    for split in ("train_split", "held_out_split"):
        assert sorted(got[split]["images"]) == sorted(want[split]["images"])
        for name, row in want[split]["images"].items():
            assert got[split]["images"][name]["golden_faces"] == row["golden_faces"]
    mine, theirs = jax_load_params_npz(got["checkpoint"]), jax_load_params_npz(want["checkpoint"])
    assert jax.tree.map(np.shape, mine) == jax.tree.map(np.shape, theirs)
