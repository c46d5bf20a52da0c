"""The port's SCRFD training (facedet_tpu_torch/train/scrfd_train.py) against
facedet_tpu/train/scrfd_train.py on the CPU, float32, on the narrow
``scrfd_500m`` of tests/test_train.py:257 (stem 8, widths 8/12/16/24, one
block per stage) with flax's init carried across.

Tolerances: ``scrfd_loss`` total and parts within 1e-5 relative and its
gradients on the level maps within 1e-5 of each map's largest; through the
model the loss within 1e-5 relative, gradients within 1e-4 of each leaf's
largest |g| or 1e-6 of the largest over all leaves, whichever is larger (a
conv bias before a norm has a gradient of 0 in exact arithmetic and holds
rounding noise only), the BatchNorm statistics (flax's momentum 0.99)
within 1e-6; one SGD step and one staged step with flip within 5e-5
(tests/test_train.py's tolerance for a step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facedet_tpu.models.scrfd import SCRFD_VARIANTS as JAX_VARIANTS
from facedet_tpu.models.scrfd import Scrfd as JaxScrfd
from facedet_tpu.train import scrfd_train as jst
from facedet_tpu.train.yolo_train import _staged_run_fn
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models.layers import FlaxBatchNorm2d
from facedet_tpu_torch.models.scrfd import SCRFD_VARIANTS, Scrfd
from facedet_tpu_torch.train import scrfd_train as tst
from facedet_tpu_torch.train import yolo_train as tyt

torch.set_num_threads(1)

NARROW = dict(stem=8, widths=(8, 12, 16, 24), depths=(1, 1, 1, 1), neck=16, head_width=16, dtype="float32")


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def leaf_state(tree):
    return from_jax.from_jax_variables(jax.tree.map(np.array, tree))


@pytest.fixture(scope="module")
def narrow():
    """(flax model, its init variables, a function making the port's model
    with them)."""
    model = JaxScrfd(dataclasses.replace(JAX_VARIANTS["scrfd_500m"], **NARROW))
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    tree = jax.tree.map(np.asarray, dict(variables))

    def port():
        m = Scrfd(dataclasses.replace(SCRFD_VARIANTS["scrfd_500m"], **NARROW))
        from_jax.load_jax_variables(m, tree)
        return m

    return model, variables, port


def make_batch(b=2, m=3, size=64, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    xy = rng.uniform(2, size - 34, (b, m, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 30, (b, m, 2))], -1).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[:, -1] = False
    boxes[~mask] = 0.0
    kpts = np.zeros((b, m, 5, 3), np.float32)
    kpts[..., 0] = rng.uniform(boxes[..., None, 0], boxes[..., None, 2])
    kpts[..., 1] = rng.uniform(boxes[..., None, 1], boxes[..., None, 3])
    kpts[..., 2] = mask[..., None] & (rng.uniform(size=(b, m, 5)) > 0.2)
    return images, boxes, mask, kpts


@pytest.mark.parametrize("with_kpts", [True, False], ids=["kps", "no-kps"])
def test_scrfd_loss_and_its_gradients_match_jax(with_kpts):
    rng = np.random.default_rng(21)
    maps = []
    for s in (8, 16, 32):
        h = 64 // s
        lvl = {"cls": (rng.standard_normal((2, h, h, 2)) - 1).astype(np.float32),
               "box": rng.uniform(0.5, 3.0, (2, h, h, 8)).astype(np.float32)}
        if with_kpts:
            lvl["kps"] = rng.standard_normal((2, h, h, 20)).astype(np.float32)
        maps.append(lvl)
    _, boxes, mask, kpts = make_batch(m=4, seed=22)
    kp = kpts if with_kpts else None

    def jf(lv):
        return jst.scrfd_loss(lv, jnp.asarray(boxes), jnp.asarray(mask), None if kp is None else jnp.asarray(kp))

    (want, want_parts), want_g = jax.value_and_grad(jf, has_aux=True)(jax.tree.map(jnp.asarray, maps))
    tmaps = [{k: torch.from_numpy(v).requires_grad_() for k, v in lv.items()} for lv in maps]
    got, parts = tst.scrfd_loss(tmaps, *t(boxes, mask), None if kp is None else torch.from_numpy(kp))
    got.backward()
    assert set(parts) == set(want_parts) == ({"box", "cls", "kps"} if with_kpts else {"box", "cls"})
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k in want_parts:
        np.testing.assert_allclose(float(parts[k].detach()), float(want_parts[k]), rtol=1e-5, err_msg=k)
    for lv_t, lv_j in zip(tmaps, want_g):
        for k, g in lv_j.items():
            g = np.asarray(g)
            np.testing.assert_allclose(lv_t[k].grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(), err_msg=k)


def test_flat_centers_are_decode_scrfds_order():
    centers, strides = tst._flat_centers([(2, 3), (1, 2), (1, 1)])
    want_c, want_s = jst._flat_centers([(2, 3), (1, 2), (1, 1)])
    np.testing.assert_array_equal(centers.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(strides.numpy(), np.asarray(want_s))


@pytest.fixture(scope="module")
def model_step(narrow):
    model, variables, port = narrow

    def loss_fn(params, batch_stats, images, boxes, mask, kpts):
        outs, mutated = model.apply({"params": params, "batch_stats": batch_stats}, images, train=True,
                                    mutable=["batch_stats"])
        total, parts = jst.scrfd_loss(outs, boxes, mask, kpts)
        return total, (parts, mutated["batch_stats"])

    batch = make_batch()
    (loss, (parts, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], *(jnp.asarray(a) for a in batch)
    )
    m = port()
    total, tparts = tyt.compute_loss(m, *t(*batch), loss=tst.scrfd_loss)
    total.backward()
    return {"jax": (loss, parts, stats, grads), "port": (m, total.detach(), tparts), "batch": batch}


def test_whole_model_gradients_and_statistics_match_jax(model_step):
    loss, parts, stats, grads = model_step["jax"]
    m, total, tparts = model_step["port"]
    np.testing.assert_allclose(float(total), float(loss), rtol=1e-5)
    for k in parts:
        np.testing.assert_allclose(float(tparts[k].detach()), float(parts[k]), rtol=1e-5, err_msg=k)
    named = dict(m.named_parameters())
    top = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(grads))
    for name, g in leaf_state({"params": grads}).items():
        g = g.numpy()
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=0, atol=max(1e-4 * np.abs(g).max(), 1e-6 * top),
                                   err_msg=name)
    buffers = dict(m.named_buffers())
    want = leaf_state({"batch_stats": stats})
    assert len(want) == 2 * sum(isinstance(x, FlaxBatchNorm2d) for x in m.modules())
    assert all(x.flax_momentum == 0.99 for x in m.modules() if isinstance(x, FlaxBatchNorm2d))
    for name, v in want.items():
        np.testing.assert_allclose(buffers[name].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=name)


def test_sgd_train_step_matches_jax(narrow, model_step):
    _, variables, port = narrow
    m = port()
    step = tst.make_scrfd_train_step(m, torch.optim.SGD(m.parameters(), lr=1e-3))
    loss, _ = step(*t(*model_step["batch"]))
    jloss, _, stats, grads = model_step["jax"]
    assert abs(float(loss) - float(jloss)) < 1e-3
    new = jax.tree.map(lambda p, g: np.asarray(p) - np.float32(1e-3) * np.asarray(g), variables["params"], grads)
    got = m.state_dict()
    for name, v in leaf_state({"params": new, "batch_stats": stats}).items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), atol=5e-5, err_msg=name)


def test_adam_steps_lower_the_loss(narrow):
    """tests/test_train.py:257's learning check: 25 Adam steps on a fixed
    batch of two bright squares lower the loss."""
    m = narrow[2]()
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    images[0, 8:24, 8:24] = 1.0
    images[1, 30:60, 20:50] = 1.0
    boxes = np.array([[[8.0, 8.0, 24.0, 24.0]], [[20.0, 30.0, 50.0, 60.0]]], np.float32)
    kpts = np.zeros((2, 1, 5, 3), np.float32)
    kpts[..., :2], kpts[..., 2] = 16.0, 1.0
    step = tst.make_scrfd_train_step(m, torch.optim.Adam(m.parameters(), lr=5e-3))
    batch = t(images, boxes, np.ones((2, 1), bool), kpts)
    losses = [float(step(*batch)[0]) for _ in range(25)]
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0], losses


def staged(n=3, b=2, m=2, size=64, seed=3):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (n, b, size, size, 3)).astype(np.uint8)
    xy = rng.uniform(4, 28, (n, b, m, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + 16.0], -1)
    mask = np.ones((n, b, m), bool)
    kpts = np.zeros((n, b, m, 5, 3), np.float32)
    kpts[..., 0] = xy[..., None, 0] + rng.uniform(0, 16, (n, b, m, 5))
    kpts[..., 1] = xy[..., None, 1] + rng.uniform(0, 16, (n, b, m, 5))
    kpts[..., 2] = 1.0
    return images, boxes, mask, kpts


def test_staged_loop_without_flip_is_the_stepwise_run(narrow):
    data = t(*staged())
    a, b = narrow[2](), narrow[2]()
    run = tst.make_scrfd_staged_loop(a, torch.optim.SGD(a.parameters(), lr=1e-3), steps_per_dispatch=2, flip=False)
    mean = run(*data)
    step = tst.make_scrfd_train_step(b, torch.optim.SGD(b.parameters(), lr=1e-3))
    losses = [float(step(data[0][j].float() * (1.0 / 255.0), data[1][j], data[2][j], data[3][j])[0]) for j in range(2)]
    np.testing.assert_allclose(float(mean), np.mean(losses), rtol=1e-6)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)


def test_staged_flip_step_matches_jax(narrow):
    """One step of the JAX SCRFD staged loop with flip (the JAX draws given
    to the port), SGD(1e-3): parameters and statistics within 5e-5."""
    model, variables, port = narrow
    images, boxes, mask, kpts = staged()
    key = jax.random.PRNGKey(1)
    flips = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 0), shape=(2,)))[None]
    assert flips.any() and not flips.all()
    tx = optax.sgd(1e-3)
    run = jax.jit(_staged_run_fn(model, tx, 1, True, loss=jst.scrfd_loss))
    p, bs, _, loss = run(variables["params"], variables["batch_stats"], tx.init(variables["params"]),
                         *(jnp.asarray(a) for a in (images, boxes, mask, kpts)), 0, key)
    m = port()
    got_loss = tst.make_scrfd_staged_loop(m, torch.optim.SGD(m.parameters(), lr=1e-3), 1, True)(
        *t(images, boxes, mask, kpts), flips=torch.from_numpy(flips)
    )
    assert abs(float(got_loss) - float(loss)) < 1e-3
    got = m.state_dict()
    for name, v in leaf_state({"params": p, "batch_stats": bs}).items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), atol=5e-5, err_msg=name)
