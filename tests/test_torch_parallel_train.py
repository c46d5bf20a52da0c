"""The port's sharded YOLO training (facedet_tpu_torch/train/yolo_train.py:
``make_sharded_train_step``, ``make_sharded_staged_train_loop``; FSDP2 over
the ``tile`` axis, the batch over ``dp``, the train-mode BatchNorm
statistics over the global batch) against facedet_tpu/train/yolo_train.py's
sharded loops on the 8-device CPU mesh, and against the port's
single-process step.

The port runs a gloo world of 4 on a (2, 2) mesh in spawned workers
(tests/test_torch_dist_workers.py, which import no jax); JAX runs in this
process meanwhile. yolo11n-pose from a flax init carried over by
``from_jax``, 64x64, batch 8 (each ``dp`` rank holds 4 images).

The AdamW step (clip 10 + AdamW, lr 2e-5, weight decay 5e-4, on both
sides), with the tolerances of tests/test_torch_train.py's single-device
step: the loss and its parts within 1e-4 relative; the BatchNorm running
statistics within 1e-5; the AdamW moments with the whole-model gradient's
tolerance, mu (a tenth of the clipped gradient) within 1e-4 of each leaf's
largest |mu| or 1e-6 of the largest over all leaves, whichever is larger, nu
(a thousandth of its square) within 2e-4 of the leaf's largest or 2e-6 of
the largest over all, between the port's runs. Against JAX the moments get
three times that: at 64x64 from a random init the two packages' whole-model
gradients differ by up to 2.1e-4 of a leaf's largest (the port's
single-process step against JAX's, measured; the convs sum in another order
and the deepest BatchNorm sees 32 values per channel). The moments hold the
gradient. The parameters, within 5e-5, hold the update's sign only:
AdamW's first update is about ``lr * sign(g)``, so on a leaf whose gradient
is rounding noise (zero in exact arithmetic) two correct runs differ by up to
``2 * lr``, and a skipped update moves a parameter by ``lr`` alone. The same
sharded step with each BatchNorm's statistics its own rank's (a group of
that rank alone) must fail these checks.

The SGD step (lr 1e-3, no clip: the update is ``lr * g``, as in
tests/test_torch_train.py's SGD step) holds the update: every parameter
within 5e-5, and within 1e-3 of the leaf's largest reference update
``|p1 - p0|`` (at least 1e-3 of the largest over all leaves: below that floor
a leaf's gradient is rounding noise) plus one float32 spacing of the
reference value (the stored parameter rounds its update; measured, the worst
leaves, BatchNorm scales near 1, differ by exactly that spacing). The
controls: the update skipped, reversed or doubled fails the gate on every
leaf whose update reaches the floor.

The clip of FSDP-sharded gradients equals the unsharded clip within 1e-6
relative (the norm sums in another order). Two staged sharded AdamW steps
with JAX's flip draws, against JAX's sharded staged loop and the port's
single-process one: the mean loss within 1e-4 relative, the parameters
within 2e-4 (the sign again), the moments within ten times the one-step
bounds, for the second gradient is taken where the first step's sign noise
has already moved the parameters (measured: the port's sharded loop against
its single-process one at 3.6 of the one-step bound, that one against JAX at
6.0). The control: with every flip reversed the moments miss by about
2e4 of the one-step bound.

A fault of the reference that the port does not copy (ROADMAP.md §3): on a
mesh whose ``tile`` axis has more than one device, JAX's sharded step gives
the head's second depthwise convs (``cls{0,1,2}_dw1``) ``tile`` times their
gradient (the first moment twice, the second four times JAX's own
single-device step's; on a (8, 1) mesh it is right). On those three leaves
JAX's moments are held divided by the tile size, and JAX's SGD update
likewise; the port's single-process step equals JAX's single-device step,
unscaled.
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

B, SIZE, M = 8, 64, 3
TILE = 2  # jax_create_mesh(8) is (dp=4, tile=2); the port's world of 4 is (2, 2)
# the leaves whose gradient JAX's sharded step multiplies by the tile size
JAX_SHARDED_FAULT = {f"head.cls{i}_dw1.conv.weight" for i in range(3)}
JAX_NOISE = 3.0  # the moments' bounds against JAX (module docstring)
STAGED_NOISE = 10.0  # the moments' bounds after two staged steps (module docstring)


def make_batch(seed=0, n=None):
    """Random boxes (one dead row per image), keypoints inside them."""
    rng = np.random.default_rng(seed)
    lead = (B,) if n is None else (n, B)
    xy = rng.uniform(4, SIZE - 24, lead + (M, 2))
    wh = rng.uniform(8, 20, lead + (M, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    mask = np.ones(lead + (M,), bool)
    mask[..., -1] = False
    boxes[~mask] = 0.0
    kpts = np.zeros(lead + (M, 5, 3), np.float32)
    kpts[..., 0] = rng.uniform(boxes[..., None, 0], np.maximum(boxes[..., None, 2], boxes[..., None, 0] + 1))
    kpts[..., 1] = rng.uniform(boxes[..., None, 1], np.maximum(boxes[..., None, 3], boxes[..., None, 1] + 1))
    kpts[..., 2] = mask[..., None]
    if n is None:
        images = rng.uniform(0, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    else:
        images = rng.integers(0, 256, (n, B, SIZE, SIZE, 3)).astype(np.uint8)
    return images, boxes, mask, kpts


def port_names(tree):
    """flax tree -> {port name: numpy}."""
    return {k: v.numpy() for k, v in from_jax.from_jax_variables(jax.tree.map(np.array, tree)).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of the port's world of 4 (every check of this file), with
    the JAX references computed here while it runs."""
    workdir = str(tmp_path_factory.mktemp("ptrain"))
    model = JaxYoloV11(JaxYoloConfig(scale="n"))
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, SIZE, SIZE, 3)), train=False))(jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    torch.save(from_jax.from_jax_variables(variables), os.path.join(workdir, "state.pt"))
    images, boxes, mask, kpts = make_batch(0)
    s_images, s_boxes, s_mask, s_kpts = make_batch(1, n=2)
    key = jax.random.PRNGKey(4)
    flips = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), shape=(B,))) for i in range(2)])
    np.savez(os.path.join(workdir, "batch.npz"), images=images, boxes=boxes, mask=mask, kpts=kpts,
             staged_images=s_images, staged_boxes=s_boxes, staged_mask=s_mask, staged_kpts=s_kpts, flips=flips)
    ctx = W.spawn(W.parallel_train_worker, 4, workdir)

    mesh = jax_create_mesh(8)  # dp=4, tile=2
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(W.TRAIN_LR, weight_decay=W.TRAIN_WD))
    p0, bs0 = variables["params"], variables["batch_stats"]
    opt0 = tx.init(p0)

    def jax_step_run(tx):
        jit_step, shard_state = jyt.make_sharded_train_step(model, tx, mesh)
        sp, sbs, sopt = shard_state(p0, bs0, tx.init(p0))
        return jit_step(sp, sbs, sopt)(sp, sbs, sopt, images, boxes, mask, kpts)

    def jax_staged_run():
        jit_run, shard_state = jyt.make_sharded_staged_train_loop(model, tx, mesh, steps_per_dispatch=2, flip=True)
        sp, sbs, sopt = shard_state(p0, bs0, opt0)
        return jit_run(p0, bs0, opt0)(sp, sbs, sopt, s_images, s_boxes, s_mask, s_kpts, 0, key)

    # the three JAX programs compile in threads of their own, side by side
    with ThreadPoolExecutor(3) as pool:
        step_fut, sgd_fut = pool.submit(jax_step_run, tx), pool.submit(jax_step_run, optax.sgd(W.SGD_LR))
        staged_fut = pool.submit(jax_staged_run)
        p1, bs1, opt1, loss, parts = step_fut.result()
        p_sgd = sgd_fut.result()[0]
        ps, _bs, opt_s, mean = staged_fut.result()
    mu, nu = _moments(opt1)
    # the reference's fault (module docstring): undone on its three leaves
    raw_mu = {name: mu[name] * TILE for name in JAX_SHARDED_FAULT}
    jax_step = {"loss": float(loss), "parts": {k: float(v) for k, v in parts.items()},
                "param": port_names({"params": p1}), "mu": mu, "nu": nu,
                "stat": port_names({"batch_stats": bs1})}
    start = port_names({"params": p0})
    sgd = port_names({"params": p_sgd})
    for name in JAX_SHARDED_FAULT:
        sgd[name] = start[name] + (sgd[name].astype(np.float64) - start[name]) / TILE
    s_mu, s_nu = _moments(opt_s)
    jax_staged = {"loss": float(mean), "param": port_names({"params": ps}), "mu": s_mu, "nu": s_nu}

    W.join(ctx)
    load = lambda rank, tag: dict(np.load(os.path.join(workdir, f"rank{rank}_{tag}.npz")))  # noqa: E731
    return {"jax_step": jax_step, "jax_staged": jax_staged, "jax_raw_mu": raw_mu, "jax_sgd": sgd,
            "start": start, "load": load}


def _moments(opt_state) -> tuple[dict, dict]:
    """The AdamW moments of JAX's clip + AdamW state as port names, with
    the reference's fault undone on its three leaves (module docstring)."""
    adam = opt_state[1][0]
    mu, nu = port_names({"params": adam.mu}), port_names({"params": adam.nu})
    for name in JAX_SHARDED_FAULT:
        mu[name], nu[name] = mu[name] / TILE, nu[name] / TILE**2
    return mu, nu


def _section(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def moment_mismatches(got: dict, want: dict, noise: float = 1.0) -> list[str]:
    """The AdamW moments of ``got`` (a worker's arrays) that fail the
    module docstring's bounds against ``want``, scaled by ``noise``."""
    bad = []
    for section, rel, floor in (("mu", 1e-4, 1e-6), ("nu", 2e-4, 2e-6)):
        top = max(np.abs(w).max() for w in want[section].values())
        mine = _section(got, section)
        assert set(mine) == set(want[section]), section
        bad += [f"{section} {name}" for name, w in want[section].items()
                if np.abs(mine[name] - w).max() > noise * max(rel * np.abs(w).max(), floor * top)]
    return bad


def step_mismatches(got: dict, want: dict, moment_noise: float = 1.0) -> list[str]:
    """Every check of the single-device step's tolerances that ``got`` (a
    worker's arrays) fails against ``want`` (same layout, or JAX's dict);
    ``moment_noise`` scales the moments' bounds (3 against JAX)."""
    bad = []
    if not np.isclose(float(got["loss"]), want["loss"], rtol=1e-4, atol=0):
        bad.append(f"loss {float(got['loss'])} vs {want['loss']}")
    for k, v in want["parts"].items():
        if not np.isclose(float(got[f"part/{k}"]), v, rtol=1e-4, atol=0):
            bad.append(f"part {k}")
    for section, check in (
        ("param", lambda g, w: np.abs(g - w).max() <= 5e-5),
        ("stat", lambda g, w: np.abs(g - w).max() <= 1e-5),
    ):
        mine = _section(got, section)
        assert set(mine) == set(want[section]), section
        bad += [f"{section} {name}" for name, w in want[section].items() if not check(mine[name], w)]
    return bad + moment_mismatches(got, want, moment_noise)


def sgd_mismatches(got: dict, want: dict, start: dict) -> list[str]:
    """The parameters after one SGD step that fail the module docstring's
    gate: within 5e-5, and within 1e-3 of the leaf's largest reference
    update ``|want - start|`` (at least 1e-3 of the largest over all
    leaves) plus one float32 spacing of the reference value."""
    update = {n: want[n].astype(np.float64) - start[n] for n in want}
    top = max(np.abs(u).max() for u in update.values())
    assert set(got) == set(want)
    bad = []
    for name, w in want.items():
        err = np.abs(got[name].astype(np.float64) - w)
        scale = max(np.abs(update[name]).max(), 1e-3 * top)
        if err.max() > 5e-5 or (err - np.spacing(np.abs(w).astype(np.float32))).max() > 1e-3 * scale:
            bad.append(name)
    return bad


def as_want(arrays: dict) -> dict:
    return {"loss": float(arrays["loss"]), "parts": {k: float(v) for k, v in _section(arrays, "part").items()},
            **{s: _section(arrays, s) for s in ("param", "mu", "nu", "stat")}}


def test_sharded_step_equals_jax_sharded_step_on_every_rank(runs):
    for rank in range(4):
        assert step_mismatches(runs["load"](rank, "sharded"), runs["jax_step"], JAX_NOISE) == [], f"rank {rank}"


def test_jax_sharded_fault_leaves_are_tile_times_the_port(runs):
    """The reference's fault, shown: on those three leaves JAX's sharded
    first moment is TILE times the port's sharded and single-process ones
    (within the moment tolerance), and unscaled it fails that tolerance."""
    top = max(np.abs(w).max() for w in runs["jax_step"]["mu"].values())
    for tag in ("sharded", "single"):
        mine = _section(runs["load"](0, tag), "mu")
        for name, raw in runs["jax_raw_mu"].items():
            tol = JAX_NOISE * max(1e-4 * np.abs(raw).max(), 1e-6 * top)
            assert np.abs(mine[name] * TILE - raw).max() <= tol, (tag, name)
            assert np.abs(mine[name] - raw).max() > tol, (tag, name)


def test_sharded_step_equals_the_single_process_step(runs):
    single = as_want(runs["load"](0, "single"))
    assert step_mismatches(runs["load"](0, "single"), runs["jax_step"], JAX_NOISE) == []
    for rank in range(4):
        assert step_mismatches(runs["load"](rank, "sharded"), single) == [], f"rank {rank}"


def test_per_rank_batchnorm_statistics_fail_the_tolerances(runs):
    """The control: with each rank's statistics its own, the step differs
    from JAX's sharded step and from the single-process one, in the
    running statistics first of all."""
    control = runs["load"](0, "per_rank_stats")
    for want, noise in ((runs["jax_step"], JAX_NOISE), (as_want(runs["load"](0, "single")), 1.0)):
        bad = step_mismatches(control, want, noise)
        assert any(b.startswith("stat ") for b in bad)
        assert any(b.startswith("loss") or b.startswith("param ") for b in bad)


def test_clip_takes_the_norm_of_the_whole_sharded_gradient(runs):
    for rank in range(4):
        c = runs["load"](rank, "clip")
        assert float(c["shard_norm"]) < 10.0 < float(c["ref_norm"])
        np.testing.assert_allclose(float(c["norm"]), float(c["ref_norm"]), rtol=1e-6)
        np.testing.assert_allclose(c["w"], c["ref_w"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(c["b"], c["ref_b"], rtol=1e-6, atol=1e-7)


def test_sharded_sgd_step_equals_jax_and_the_single_process_step(runs):
    """One SGD step (the update is ``lr * g``): every rank's parameters
    against JAX's sharded step (its fault undone) and the port's
    single-process step, and that one against JAX's, under the SGD gate."""
    start, jax_sgd = runs["start"], runs["jax_sgd"]
    single = _section(runs["load"](0, "single_sgd"), "param")
    assert sgd_mismatches(single, jax_sgd, start) == []
    for rank in range(4):
        got = _section(runs["load"](rank, "sharded_sgd"), "param")
        assert sgd_mismatches(got, jax_sgd, start) == [], f"rank {rank}"
        assert sgd_mismatches(got, single, start) == [], f"rank {rank}"


@pytest.mark.parametrize("control", ["skipped", "reversed", "doubled"])
def test_the_sgd_gate_fails_a_wrong_update(runs, control):
    """The gate can fail: the parameters with the update skipped, reversed or
    doubled fail it on every leaf whose reference update reaches the gate's
    floor (1e-3 of the largest; below it a gradient is rounding noise, zero
    in exact arithmetic), and on no other leaf of the ones that moved."""
    start, want = runs["start"], runs["jax_sgd"]
    got = _section(runs["load"](0, "sharded_sgd"), "param")
    factor = {"skipped": 0.0, "reversed": -1.0, "doubled": 2.0}[control]
    wrong = {n: (start[n] + factor * (got[n].astype(np.float64) - start[n])).astype(np.float32) for n in got}
    update = {n: np.abs(want[n].astype(np.float64) - start[n]).max() for n in want}
    top = max(update.values())
    resolved = {n for n, u in update.items() if u >= 1e-3 * top}
    assert len(resolved) > 100
    bad = set(sgd_mismatches(wrong, want, start))
    assert resolved <= bad <= {n for n, u in update.items() if u > 0}


def test_two_staged_sharded_steps_match_jax(runs):
    """Two staged AdamW steps fed JAX's flips: the mean loss, the parameters
    and both moments against JAX's sharded staged loop (its fault undone)
    and against the port's single-process staged loop."""
    want = runs["jax_staged"]
    single = runs["load"](0, "single_staged")
    assert moment_mismatches(single, want, STAGED_NOISE) == []
    single = {"mu": _section(single, "mu"), "nu": _section(single, "nu")}
    for rank in range(4):
        got = runs["load"](rank, "staged")
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-4)
        params = _section(got, "param")
        assert set(params) == set(want["param"])
        for name, w in want["param"].items():
            np.testing.assert_allclose(params[name], w, rtol=0, atol=2e-4, err_msg=f"rank {rank} {name}")
        assert moment_mismatches(got, want, STAGED_NOISE) == [], f"rank {rank}"
        assert moment_mismatches(got, single, STAGED_NOISE) == [], f"rank {rank}"


def test_staged_steps_with_the_flips_reversed_fail_the_moments(runs):
    """The staged loop's control: the same two steps with every flip
    reversed fail the moment bounds against JAX."""
    bad = moment_mismatches(runs["load"](0, "staged_flipped"), runs["jax_staged"], STAGED_NOISE)
    assert sum(b.startswith("mu ") for b in bad) > 50 and sum(b.startswith("nu ") for b in bad) > 50



