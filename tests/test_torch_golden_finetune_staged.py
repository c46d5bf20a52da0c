"""The staged mode of the port's golden fine-tune
(facedet_tpu_torch/tools/golden_finetune.train_yolo, ``args.staged``) fed
JAX's own flip draws, with the dispatch EMA, against
facedet_tpu/tools/golden_finetune.train_yolo on the CPU.

Tolerances: yolo11n-pose at 64x64, batch 2, one step per dispatch, EMA
0.9, from JAX's init on the same staged batches and flips: the first
dispatch's mean loss within 1e-4 relative (phase 24's gate); after AdamW's
first update (``lr * sign(g)`` but for the smallest gradients: an element
within rounding of 0 moves either way, by 2 * lr) the second within 1e-2
and the EMA parameters (``dd * p1 + (1 - dd) * p2``) within 4 * lr of
JAX's. How each package wires its EMA in is held exactly: the final
parameters of each equal, bit for bit, the reference's dispatch rule
(``dispatch_ema``) applied to that package's own parameters after each
dispatch, and equal neither the last dispatch's parameters (no EMA) nor the
rule started from the initial parameters. tests/test_torch_golden_finetune_ema.py
holds the rule at two steps per dispatch, where ``ema ** spd`` decides.

The recorders and ``dispatch_ema`` here serve the other arms' tests too.
"""
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from facedet_tpu.tools import golden_finetune as jgf
from facedet_tpu.train import yolo_train as jyt
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.tools import golden_finetune as tgf
from facedet_tpu_torch.tools import reference_goldens as trg
from facedet_tpu_torch.train import yolo_train as tyt
from facedet_tpu_torch.utils.synth import synthetic_reference_tree

torch.set_num_threads(1)

LR = 2e-3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reference"))
    synthetic_reference_tree(root, n_images=4, hw=(256, 384), n_faces=5, size=(30, 70), seed=9)
    gp = os.path.join(root, "goldens.json")
    with open(gp, "w") as f:
        json.dump(trg.extract_goldens(root), f)
    return root, gp


def _args(**kw):
    base = dict(model="yolo", scale="n", size=64, steps=2, lr=LR, batch=2, staged=2, steps_per_dispatch=1,
                mosaic_prob=0.4, no_jitter=False, ema=0.9, scale_range_t=(0.6, 1.6), device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


def record_jax_staged(module, name, calls):
    """Wrap the JAX staged-loop factory ``module.name``: each dispatch
    appends a dict of its input variables (numpy), its key, its mean loss
    and its output params and statistics (numpy) to ``calls``."""
    real = getattr(module, name)

    def factory(*a, **k):
        run = real(*a, **k)

        def wrapped(*args):
            inputs = jax.tree.map(np.asarray, {"params": args[0], "batch_stats": args[1]})
            out = run(*args)
            calls.append({"inputs": inputs, "key": args[-1], "loss": float(out[-1]),
                          "params": jax.tree.map(np.asarray, out[0]),
                          "batch_stats": jax.tree.map(np.asarray, out[1])})
            return out

        return wrapped

    return factory


def record_port_staged(module, name, snapshots):
    """Wrap the port's staged-loop factory ``module.name`` (its model first):
    each dispatch appends the model's parameters after it, by name, to
    ``snapshots``."""
    real = getattr(module, name)

    def factory(model, *a, **k):
        run = real(model, *a, **k)

        def wrapped(*args, **kw):
            out = run(*args, **kw)
            snapshots.append({n: p.detach().clone() for n, p in model.named_parameters()})
            return out

        return wrapped

    return factory


def jax_flips(key, spd, batch):
    """The flip draws of one dispatch of JAX's staged loop:
    ``bernoulli(fold_in(key, i))`` for step i of the dispatch."""
    return np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), shape=(batch,)))
                     for i in range(spd)])


def dispatch_ema(snapshots, decay, spd, dd=None):
    """The reference's dispatch EMA (tools/golden_finetune.py, the staged
    branch of train_yolo) over per-dispatch parameter trees (dicts of
    tensors or arrays): the shadow starts at the first dispatch's
    parameters, then ``e * dd + p * (1 - dd)`` with
    ``dd = min(decay ** spd, (1 + n) / (10 + n))`` at dispatch n. ``dd``
    (a function of n) replaces that decay, for the controls."""
    dd = dd or (lambda n: min(decay**spd, (1 + n) / (10 + n)))
    shadow = dict(snapshots[0])
    for n, p in enumerate(snapshots[1:], start=1):
        d = dd(n)
        shadow = {k: shadow[k] * d + p[k] * (1 - d) for k in shadow}
    return shadow


def flat_params(tree):
    """A flax params tree as {path: array}."""
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def equal_trees(a, b):
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def record_optax(monkeypatch, log):
    """Record the JAX tool's optimizers: each ``clip_by_global_norm`` and
    the ``adam`` / ``adamw`` after it append one dict (``max_norm``,
    ``weight_decay``, ``schedule``: a count -> float) to ``log``."""
    import optax

    real = {n: getattr(optax, n) for n in ("clip_by_global_norm", "adam", "adamw")}

    def clip(max_norm):
        log.append({"max_norm": float(max_norm)})
        return real["clip_by_global_norm"](max_norm)

    def adam_like(name, default_wd):
        def make(learning_rate, *a, **k):
            sched = learning_rate if callable(learning_rate) else (lambda c, v=learning_rate: v)
            log[-1].update(schedule=lambda c: float(sched(c)), weight_decay=k.get("weight_decay", default_wd))
            return real[name](learning_rate, *a, **k)

        return make

    monkeypatch.setattr(optax, "clip_by_global_norm", clip)
    monkeypatch.setattr(optax, "adam", adam_like("adam", 0.0))
    monkeypatch.setattr(optax, "adamw", adam_like("adamw", 1e-4))  # optax's default


def record_clipped_adamw(monkeypatch, log):
    """Record the port's optimizers (train/yolo_train.ClippedAdamW) in the
    form of ``record_optax``'s."""
    real = tyt.ClippedAdamW

    class Recording(real):
        def __init__(self, params, schedule, weight_decay, max_norm=10.0):
            log.append({"max_norm": float(max_norm), "weight_decay": weight_decay,
                        "schedule": lambda c: float(schedule(c))})
            super().__init__(params, schedule, weight_decay, max_norm)

    monkeypatch.setattr(tyt, "ClippedAdamW", Recording)


def same_optimizers(got, want, counts):
    """The port's optimizers are the JAX tool's: the same clip norms and
    weight decays, and schedules within float32 rounding at every count in
    ``counts``: 1e-6 of the schedule's peak (optax computes in float32, and
    its warmup ``peak - peak * (1 - c / n)`` cancels)."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["max_norm"], g["weight_decay"]) == (w["max_norm"], w["weight_decay"])
        ref = np.array([w["schedule"](c) for c in counts])
        np.testing.assert_allclose([g["schedule"](c) for c in counts], ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_staged_mode_with_jax_draws_and_dispatch_ema(tree, monkeypatch):
    root, gp = tree
    calls = []
    monkeypatch.setattr(jyt, "make_staged_train_loop", record_jax_staged(jyt, "make_staged_train_loop", calls))
    records = jgf.load_golden_dataset(gp, root)
    jdet, _ = jgf.train_yolo(_args(), records)
    assert len(calls) == 2
    flips = [jax_flips(c["key"], 1, 2) for c in calls]
    snapshots = []
    monkeypatch.setattr(tyt, "make_staged_train_loop", record_port_staged(tyt, "make_staged_train_loop", snapshots))
    history = []
    det, _ = tgf.train_yolo(_args(), tgf.load_golden_dataset(gp, root),
                            variables=calls[0]["inputs"], flips=flips, history=history)
    assert [h[0] for h in history] == [1, 2]
    np.testing.assert_allclose(history[0][1], calls[0]["loss"], rtol=1e-4)
    np.testing.assert_allclose(history[1][1], calls[1]["loss"], rtol=1e-2)
    # ROADMAP §3 item 8: JAX's detector says bfloat16 and computes float32
    assert (jdet.dtype, jdet.cfg.dtype) == ("bfloat16", "float32")
    assert (det.dtype, det.model.cfg.dtype) == ("float32", "float32")
    want = from_jax.from_jax_variables(jax.tree.map(np.asarray, jdet.variables))
    for name, v in want.items():
        if v.is_floating_point() and "running" not in name:
            assert float((det.train_state[name] - v).abs().max()) <= 4 * LR * (1 + 1e-3), name

    # each package's EMA is the reference's rule on its own parameters
    got = {n: det.train_state[n] for n in snapshots[0]}
    assert len(snapshots) == 2
    assert equal_trees(got, dispatch_ema(snapshots, 0.9, 1))
    jax_got = flat_params(jdet.variables["params"])
    jax_snaps = [flat_params(c["params"]) for c in calls]
    assert equal_trees(jax_got, dispatch_ema(jax_snaps, 0.9, 1))
    # controls the check must tell apart: no EMA, and a shadow started at the init
    port_init = {n: p.detach() for n, p in from_jax_named_params(calls[0]["inputs"], det)}
    jax_init = flat_params(calls[0]["inputs"]["params"])
    for snaps, final, init in ((snapshots, got, port_init), (jax_snaps, jax_got, jax_init)):
        assert not equal_trees(final, snaps[-1])
        assert not equal_trees(final, dispatch_ema([init] + snaps, 0.9, 1))


def from_jax_named_params(variables, det):
    """The port's parameters, by name, of flax ``variables``."""
    state = from_jax.from_jax_variables(variables)
    return [(n, state[n]) for n, _p in det.model.named_parameters()]
