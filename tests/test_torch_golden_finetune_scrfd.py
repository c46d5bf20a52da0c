"""The SCRFD arm of the port's golden fine-tune
(facedet_tpu_torch/tools/golden_finetune.train_yolo with ``model="scrfd"``)
against facedet_tpu/tools/golden_finetune.train_yolo's on the CPU, staged,
fed JAX's init and flip draws.

scrfd_500m at 128x128, batch 2, two dispatches of one step, EMA 0.9.
Tolerances, stated per check:
  * the optimizer (clip 10, AdamW weight decay 5e-4) equal to the JAX
    tool's, its schedule within float32 rounding (1e-6 of its peak);
  * the first dispatch's loss within 1e-4 relative (phase 24's gate), the
    second within 1e-2 (after AdamW's first update, ``lr * sign(g)`` but for
    gradients within rounding of 0, which move either way);
  * the parameters after the two steps within 4 * lr of JAX's and at most
    1% of the elements more than lr / 2 apart (phase 24's gates after two
    steps, as tests/test_torch_golden_finetune.py holds the yolo arm);
  * each package's final (EMA) parameters equal, bit for bit, the
    reference's dispatch rule on its own parameters after each dispatch,
    and neither the last dispatch's parameters nor the rule started at the
    initial parameters.
"""
import types

import numpy as np
import torch

from facedet_tpu.tools import golden_finetune as jgf
from facedet_tpu.train import scrfd_train as jst
from facedet_tpu_torch.tools import golden_finetune as tgf
from facedet_tpu_torch.train import scrfd_train as tst
from test_torch_golden_finetune_ema import within_two_step_gates
from test_torch_golden_finetune_staged import (
    dispatch_ema, equal_trees, flat_params, from_jax_named_params, jax_flips, record_clipped_adamw, record_jax_staged,
    record_optax, record_port_staged, same_optimizers,
    tree,  # noqa: F401  (the fixture)
)

torch.set_num_threads(1)

LR = 2e-3


def _args():
    return types.SimpleNamespace(model="scrfd", variant="scrfd_500m", scale="n", size=128, steps=2, lr=LR, batch=2,
                                 staged=2, steps_per_dispatch=1, mosaic_prob=0.4, no_jitter=False, ema=0.9,
                                 scale_range_t=(0.6, 1.6), device="cpu")


def test_scrfd_arm_against_the_jax_arm(tree, monkeypatch):
    root, gp = tree
    calls, jax_opts, port_opts, snapshots, history = [], [], [], [], []
    record_optax(monkeypatch, jax_opts)
    record_clipped_adamw(monkeypatch, port_opts)
    monkeypatch.setattr(jst, "make_scrfd_staged_loop", record_jax_staged(jst, "make_scrfd_staged_loop", calls))
    monkeypatch.setattr(tst, "make_scrfd_staged_loop", record_port_staged(tst, "make_scrfd_staged_loop", snapshots))
    jdet, _ = jgf.train_yolo(_args(), jgf.load_golden_dataset(gp, root))
    assert len(calls) == 2
    det, _ = tgf.train_yolo(_args(), tgf.load_golden_dataset(gp, root), variables=calls[0]["inputs"],
                            flips=[jax_flips(c["key"], 1, 2) for c in calls], history=history)
    assert type(det).__name__ == type(jdet).__name__ == "ScrfdDetectionModel"
    assert [h[0] for h in history] == [1, 2] and len(snapshots) == 2
    same_optimizers(port_opts, jax_opts, range(4))
    np.testing.assert_allclose(history[0][1], calls[0]["loss"], rtol=1e-4)
    np.testing.assert_allclose(history[1][1], calls[1]["loss"], rtol=1e-2)
    last = {"params": calls[1]["params"], "batch_stats": calls[1]["batch_stats"]}
    within_two_step_gates(snapshots[1], dict(from_jax_named_params(last, det)))

    got = {n: det.train_state[n] for n in snapshots[0]}
    jax_snaps = [flat_params(c["params"]) for c in calls]
    jax_got = flat_params(jdet.variables["params"])
    port_init = dict(from_jax_named_params(calls[0]["inputs"], det))
    jax_init = flat_params(calls[0]["inputs"]["params"])
    for snaps, final, init in ((snapshots, got, port_init), (jax_snaps, jax_got, jax_init)):
        assert equal_trees(final, dispatch_ema(snaps, 0.9, 1))
        assert not equal_trees(final, snaps[-1])
        assert not equal_trees(final, dispatch_ema([init] + snaps, 0.9, 1))
