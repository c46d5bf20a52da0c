"""The staged golden fine-tune at two steps per dispatch, where the dispatch
EMA's decay is ``ema ** spd`` (facedet_tpu_torch/tools/golden_finetune.train_yolo
against facedet_tpu/tools/golden_finetune.train_yolo on the CPU).

yolo11n-pose at 128x128, batch 2, two dispatches of two steps, EMA 0.4, from
JAX's init on the same staged batches and JAX's flip draws. At the second
dispatch ``0.4 ** 2 = 0.16`` is below the warmup ``2 / 11``, so the
compounded decay is the one applied. Tolerances, stated per check:
  * the optimizer (clip norm, weight decay) equal to the JAX tool's, and
    its schedule within float32 rounding (1e-6 of its peak) at every count;
  * each package's final parameters equal, bit for bit, the reference's
    dispatch rule (tests/test_torch_golden_finetune_staged.dispatch_ema)
    applied to its own parameters after each dispatch, and differ from the
    same rule with the per-step decay ``min(ema, (1 + n) / (10 + n))``, from
    the last dispatch's parameters (no EMA) and from the rule started at the
    initial parameters;
  * the first dispatch (two steps) against JAX's under phase 24's gates
    after two AdamW steps (tests/test_torch_golden_finetune.py): the mean
    loss within 1e-2 relative, since its second step follows AdamW's first
    update, ``lr * sign(g)`` but for gradients within rounding of 0, which
    move either way; every parameter within 4 * lr and at most 1% of the
    elements more than lr / 2 apart.
The second dispatch is held by the rule on each side only: from the third
step on the two runs part where those elements went opposite ways (at this
size 9% of the elements lie more than lr / 2 apart after four steps), and
no gate across the packages holds there.
"""
import types

import numpy as np
import torch

from facedet_tpu.tools import golden_finetune as jgf
from facedet_tpu.train import yolo_train as jyt
from facedet_tpu_torch.tools import golden_finetune as tgf
from facedet_tpu_torch.train import yolo_train as tyt
from test_torch_golden_finetune_staged import (
    dispatch_ema, equal_trees, flat_params, from_jax_named_params, jax_flips, record_clipped_adamw, record_jax_staged,
    record_optax, record_port_staged, same_optimizers,
    tree,  # noqa: F401  (the fixture)
)

torch.set_num_threads(1)

LR, EMA, SPD = 2e-3, 0.4, 2


def _args():
    return types.SimpleNamespace(model="yolo", scale="n", size=128, steps=4, lr=LR, batch=2, staged=2,
                                 steps_per_dispatch=SPD, mosaic_prob=0.4, no_jitter=False, ema=EMA,
                                 scale_range_t=(0.6, 1.6), device="cpu")


def within_two_step_gates(got: dict, want: dict):
    """Phase 24's gates after two AdamW steps: ``got`` (port tensors by
    name) within 4 * lr of ``want`` everywhere, and at most 1% of the
    elements more than lr / 2 apart."""
    moved = total = 0
    for name, v in want.items():
        diff = (got[name] - v).abs()
        assert float(diff.max()) <= 4 * LR * (1 + 1e-3), name
        moved += int((diff > LR / 2).sum())
        total += v.numel()
    assert moved <= 0.01 * total, (moved, total)


def test_dispatch_ema_compounds_over_the_dispatch(tree, monkeypatch):
    root, gp = tree
    assert EMA**SPD < 2 / 11 < EMA  # the second dispatch's decay is ema ** spd, not the warmup's
    calls, jax_opts, port_opts = [], [], []
    record_optax(monkeypatch, jax_opts)
    record_clipped_adamw(monkeypatch, port_opts)
    monkeypatch.setattr(jyt, "make_staged_train_loop", record_jax_staged(jyt, "make_staged_train_loop", calls))
    jdet, _ = jgf.train_yolo(_args(), jgf.load_golden_dataset(gp, root))
    assert len(calls) == 2
    snapshots, history = [], []
    monkeypatch.setattr(tyt, "make_staged_train_loop", record_port_staged(tyt, "make_staged_train_loop", snapshots))
    det, _ = tgf.train_yolo(_args(), tgf.load_golden_dataset(gp, root), variables=calls[0]["inputs"],
                            flips=[jax_flips(c["key"], SPD, 2) for c in calls], history=history)
    assert [h[0] for h in history] == [2, 4] and len(snapshots) == 2
    # clip 10, AdamW at 5e-4, cosine from lr to lr / 100
    same_optimizers(port_opts, jax_opts, range(6))

    per_step = lambda n: min(EMA, (1 + n) / (10 + n))  # noqa: E731
    port_init = dict(from_jax_named_params(calls[0]["inputs"], det))
    got = {n: det.train_state[n] for n in snapshots[0]}
    jax_snaps = [flat_params(c["params"]) for c in calls]
    jax_got = flat_params(jdet.variables["params"])
    jax_init = flat_params(calls[0]["inputs"]["params"])
    for snaps, final, init in ((snapshots, got, port_init), (jax_snaps, jax_got, jax_init)):
        assert equal_trees(final, dispatch_ema(snaps, EMA, SPD))
        assert not equal_trees(final, dispatch_ema(snaps, EMA, SPD, dd=per_step))
        assert not equal_trees(final, snaps[-1])
        assert not equal_trees(final, dispatch_ema([init] + snaps, EMA, SPD))

    # across the packages: the first dispatch, two AdamW steps
    np.testing.assert_allclose(history[0][1], calls[0]["loss"], rtol=1e-2)
    first = {"params": calls[0]["params"], "batch_stats": calls[0]["batch_stats"]}
    within_two_step_gates(snapshots[0], dict(from_jax_named_params(first, det)))
    assert np.isfinite(history[1][1])
