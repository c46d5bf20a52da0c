"""The port's sharded YOLO training with a bfloat16 config
(facedet_tpu_torch/train/yolo_train.py: ``make_sharded_train_step``,
``make_sharded_staged_train_loop``; FSDP2 over ``tile``, the all-gathered
conv and linear weights cast to bfloat16 for each forward, float32
parameters, gradients and optimizer state) against the port's
single-process bfloat16 step and against facedet_tpu/train/yolo_train.py's
sharded step on the 8-device CPU mesh.

The port runs a gloo world of 2 on a (1, 2) mesh (every parameter the plan
shards is split over the two ``tile`` ranks) in spawned workers
(tests/test_torch_dist_workers.py); JAX runs in this process meanwhile.
yolo11n-pose from a flax init carried over by ``from_jax``, 64x64, batch 8,
the AdamW step of tests/test_torch_parallel_train.py (clip 10 + AdamW, lr
2e-5, weight decay 5e-4).

Against the port's single-process step, the sharded step holds float32's
gates (tests/test_torch_parallel_train.py): with ``dp`` of 1 both run the
same bfloat16 forward on the same whole weights, and the two ``tile`` ranks'
gradients are equal, so their mean is exact.

Against JAX the gates are bfloat16's, derived from the port's
single-process bfloat16 step against JAX's single-device one at this size
(measured: the loss 1.1e-3 relative, the parts 5.8e-3, the BatchNorm
statistics 7.0e-4 and the AdamW moments 0.47 (mu) and 0.53 (nu) as the norm
of the difference over the norm of JAX's, over all leaves, the parameters
4.0e-5, which is twice lr: AdamW's first update is about ``lr * sign(g)``).
bfloat16 rounding makes the gradient itself that uncertain: JAX's step
against JAX's step on images one float32 ulp apart moves the loss by 1.8e-3,
the parts by 1.8e-2 and the moments by 0.28 and 0.33. The gates (``BF16``)
are the measured values with a margin: the loss 5e-3, the parts 5e-2, the
statistics 5e-3, the moments 0.8, the parameters 5e-5. The control: the
port's float32 step misses them, by its loss (5.8e-3 relative, measured;
its moments, 0.45 and 0.51, are as near JAX's bfloat16 ones as the port's
bfloat16 step's: at this size bfloat16 rounding moves the gradient as far
as the whole difference between the two dtypes). The port's sharded
bfloat16 step against JAX's sharded one: the loss 3.1e-4, the parts 2.5e-2,
the statistics 6.3e-4, the moments 0.42 and 0.49 (measured).

The reference's fault (ROADMAP.md §3 item 6): on its (4, 2) mesh JAX's
sharded step gives ``head.cls*_dw1`` the tile size times their gradient;
those leaves of JAX's moments are divided by it, as
tests/test_torch_parallel_train.py does.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_dist_workers as W
from facedet_tpu.models.yolov11 import YoloConfig as JaxYoloConfig
from facedet_tpu.models.yolov11 import YoloV11 as JaxYoloV11
from facedet_tpu.parallel.mesh import create_mesh as jax_create_mesh
from facedet_tpu.train import yolo_train as jyt
from facedet_tpu_torch.models import from_jax
from test_torch_parallel_train import (
    B,
    JAX_SHARDED_FAULT,
    SIZE,
    TILE,
    _moments,
    _section,
    as_want,
    make_batch,
    moment_mismatches,
    port_names,
    step_mismatches,
)

torch.set_num_threads(1)

# the gates against JAX (module docstring): relative for the loss and the
# parts, the norm of the difference over the norm of JAX's for the
# statistics and the moments, absolute for the parameters
BF16 = {"loss": 5e-3, "part": 5e-2, "stat": 5e-3, "mu": 0.8, "nu": 0.8, "param": 5e-5}


def bf16_errors(got: dict, want: dict) -> dict:
    """The measures that ``BF16`` gates: ``got`` a worker's arrays, ``want``
    JAX's dict."""
    def rel_norm(section):
        mine = _section(got, section)
        assert set(mine) == set(want[section]), section
        num = sum(float(np.square(mine[n].astype(np.float64) - w).sum()) for n, w in want[section].items())
        return (num / sum(float(np.square(w.astype(np.float64)).sum()) for w in want[section].values())) ** 0.5

    params = _section(got, "param")
    return {
        "loss": abs(float(got["loss"]) - want["loss"]) / abs(want["loss"]),
        "part": max(abs(float(got[f"part/{k}"]) - v) / abs(v) for k, v in want["parts"].items() if v),
        "stat": rel_norm("stat"), "mu": rel_norm("mu"), "nu": rel_norm("nu"),
        "param": max(float(np.abs(params[n] - w).max()) for n, w in want["param"].items()),
    }


def bf16_mismatches(got: dict, want: dict) -> list[str]:
    errs = bf16_errors(got, want)
    return [f"{k} {v:.3g} > {BF16[k]}" for k, v in errs.items() if not v <= BF16[k]]


def _jax_step(step, p0, bs0, tx, batch):
    p1, bs1, opt1, loss, parts = step(p0, bs0, tx.init(p0), *batch)
    mu, nu = port_names({"params": opt1[1][0].mu}), port_names({"params": opt1[1][0].nu})
    return {"loss": float(loss), "parts": {k: float(v) for k, v in parts.items()},
            "param": port_names({"params": p1}), "mu": mu, "nu": nu, "stat": port_names({"batch_stats": bs1})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of the port's world of 2, with JAX's single-device and
    sharded bfloat16 steps computed here while it runs."""
    workdir = str(tmp_path_factory.mktemp("ptrain_bf16"))
    model = JaxYoloV11(JaxYoloConfig(scale="n", dtype="bfloat16"))
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, SIZE, SIZE, 3)), train=False))(jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    torch.save(from_jax.from_jax_variables(variables), os.path.join(workdir, "state.pt"))
    batch = make_batch(0)
    s_images, s_boxes, s_mask, s_kpts = make_batch(1, n=2)
    key = jax.random.PRNGKey(4)
    flips = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), shape=(B,))) for i in range(2)])
    np.savez(os.path.join(workdir, "batch.npz"), images=batch[0], boxes=batch[1], mask=batch[2], kpts=batch[3],
             staged_images=s_images, staged_boxes=s_boxes, staged_mask=s_mask, staged_kpts=s_kpts, flips=flips)
    ctx = W.spawn(W.parallel_train_bf16_worker, 2, workdir)

    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(W.TRAIN_LR, weight_decay=W.TRAIN_WD))
    p0, bs0 = variables["params"], variables["batch_stats"]

    def sharded_run():
        jit_step, shard_state = jyt.make_sharded_train_step(model, tx, jax_create_mesh(8))  # dp=4, tile=2
        sp, sbs, sopt = shard_state(p0, bs0, tx.init(p0))
        return jit_step(sp, sbs, sopt)(sp, sbs, sopt, *batch)

    # the two JAX programs compile side by side
    with ThreadPoolExecutor(2) as pool:
        sharded_fut = pool.submit(sharded_run)
        single = _jax_step(jyt.make_train_step(model, tx), p0, bs0, tx, batch)
        p1, bs1, opt1, loss, parts = sharded_fut.result()
    mu, nu = _moments(opt1)  # the reference's fault undone on its three leaves
    sharded = {"loss": float(loss), "parts": {k: float(v) for k, v in parts.items()},
               "param": port_names({"params": p1}), "mu": mu, "nu": nu, "stat": port_names({"batch_stats": bs1})}
    raw_mu = {name: mu[name] * TILE for name in JAX_SHARDED_FAULT}
    W.join(ctx)
    load = lambda rank, tag: dict(np.load(os.path.join(workdir, f"rank{rank}_{tag}.npz")))  # noqa: E731
    return {"jax_single": single, "jax_sharded": sharded, "jax_raw_mu": raw_mu, "load": load}


def test_single_process_bfloat16_step_is_within_the_gates_of_jax(runs):
    """Where the gates come from: the port's single-process bfloat16 step
    against JAX's single-device one; the port's float32 step (the control)
    misses them."""
    assert bf16_mismatches(runs["load"](0, "single"), runs["jax_single"]) == []
    assert bf16_mismatches(runs["load"](0, "single_float32"), runs["jax_single"]) != []


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_bfloat16_step_equals_the_single_process_step(runs, rank):
    single = runs["load"](0, "single")
    got = runs["load"](rank, "sharded")
    assert step_mismatches(got, as_want(single)) == []
    assert float(got["loss"]) == float(single["loss"])


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_bfloat16_step_is_within_the_gates_of_jax_sharded_step(runs, rank):
    assert bf16_mismatches(runs["load"](rank, "sharded"), runs["jax_sharded"]) == []


def test_jax_sharded_fault_leaves_are_tile_times_the_port_in_bfloat16(runs):
    """The reference's fault in bfloat16 too: JAX's sharded first moment on
    those three leaves is nearer TILE times the port's than the port's."""
    mine = _section(runs["load"](0, "sharded"), "mu")
    for name, raw in runs["jax_raw_mu"].items():
        assert np.linalg.norm(mine[name] * TILE - raw) < np.linalg.norm(mine[name] - raw), name


@pytest.mark.parametrize("rank", [0, 1])
def test_two_staged_sharded_bfloat16_steps_equal_the_single_process_loop(runs, rank):
    want = runs["load"](0, "single_staged")
    got = runs["load"](rank, "staged")
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
    params = _section(got, "param")
    for name, w in _section(want, "param").items():
        np.testing.assert_allclose(params[name], w, rtol=0, atol=1e-7, err_msg=name)
    single = {"mu": _section(want, "mu"), "nu": _section(want, "nu")}
    assert moment_mismatches(got, single) == []
