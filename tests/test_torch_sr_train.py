"""The port's SR restoration training (facedet_tpu_torch/train/sr_train.py)
against facedet_tpu/train/sr_train.py on the CPU, float32, on a narrow
RRDBNet (x2, one block, 16 features) with seeded weights carried across by
``models/from_jax.py``.

Tolerances: the degradation model, ``usm_sharpen`` and ``build_sr_dataset``
bit for bit (uint8), ``psnr`` exactly; ``sr_loss`` within 1e-6 relative;
the EMA decay bit for bit against JAX's float32; one SGD step: the loss
within 1e-5 relative, the parameters within 1e-6; the clip at 5 and three
Adam steps on the same given gradients within 1e-6; the staged loop with
``flip=False`` equal to single steps bit for bit; three staged SGD steps
fed JAX's flip draws against the JAX loop: the mean loss within 1e-5
relative, parameters and the EMA shadow within 1e-6.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facedet_tpu.models.rrdbnet import RRDBConfig as JaxRRDBConfig
from facedet_tpu.models.rrdbnet import RRDBNet as JaxRRDBNet
from facedet_tpu.train import sr_train as jst
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models.rrdbnet import RRDBConfig, RRDBNet
from facedet_tpu_torch.train import sr_train as tst
from facedet_tpu_torch.train.yolo_train import ClippedAdamW, WarmupCosineDecay
from test_torch_scrfd import seeded_variables

torch.set_num_threads(1)

NARROW = dict(scale=2, num_block=1, num_feat=16, num_grow_ch=8)


def _toy_images(n=3, size=96, seed=0):
    """tests/test_sr_train.py's blocky images, and one smooth photo-like one."""
    rng = np.random.default_rng(seed)
    imgs = [np.kron(rng.integers(0, 256, (size // 8, size // 8, 3), np.uint8), np.ones((8, 8, 1), np.uint8))
            for _ in range(n)]
    yy, xx = np.mgrid[0:size, 0:size + 20]
    imgs.append(np.clip(np.stack([128 + 100 * np.sin(xx / 7.0), 128 + 90 * np.cos(yy / 5.0), (xx + yy) % 256], -1),
                        0, 255).astype(np.uint8))
    return imgs


@pytest.mark.parametrize("scale", [2, 4])
def test_degradation_is_bit_for_bit(scale):
    imgs = _toy_images(seed=scale)
    for i, hr in enumerate(imgs):
        a, b = np.random.default_rng(10 + i), np.random.default_rng(10 + i)
        for _ in range(3):  # several draws from one generator
            np.testing.assert_array_equal(tst.degrade_patch(hr, a, scale), jst.degrade_patch(hr, b, scale))
        np.testing.assert_array_equal(tst.degrade_image(hr, scale, seed=i), jst.degrade_image(hr, scale, seed=i))
        np.testing.assert_array_equal(tst.usm_sharpen(hr, 0.5, 2.0, 10.0), jst.usm_sharpen(hr, 0.5, 2.0, 10.0))


def test_build_sr_dataset_is_bit_for_bit():
    imgs = _toy_images(seed=3)
    boxes = [np.array([[10.0, 10.0, 40.0, 40.0]]), np.zeros((0, 4)), np.array([[50.0, 20.0, 90.0, 70.0]]), None]
    for kw in (dict(seed=1), dict(seed=2, face_boxes=boxes, face_fraction=0.7), dict(seed=4, usm_weight=0.5)):
        got, want = tst.build_sr_dataset(imgs, 9, 48, 2, **kw), jst.build_sr_dataset(imgs, 9, 48, 2, **kw)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="no image"):
        tst.build_sr_dataset(imgs, 4, 512, 2)


def test_sr_loss_psnr_and_ema_decay_match_jax():
    rng = np.random.default_rng(5)
    a, b = (rng.random((2, 8, 8, 3), np.float32) for _ in range(2))
    np.testing.assert_allclose(float(tst.sr_loss(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jst.sr_loss(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    assert float(tst.sr_loss(torch.zeros(2, 4, 4, 3), torch.zeros(2, 4, 4, 3))) == pytest.approx(1e-3, rel=1e-3)
    x = (a * 255).astype(np.uint8)
    y = x.copy()
    y[0, 0, 0] = 255 - y[0, 0, 0]
    assert tst.psnr(x, y) == jst.psnr(x, y) and tst.psnr(x, x) == float("inf")
    for g in (0, 1, 7, 100, 9000, 123456):
        want = jnp.minimum(0.999, (1.0 + jnp.int32(g)) / (10.0 + jnp.int32(g)))
        d, one_minus = tst.ema_decay_at(g, 0.999)
        assert d == float(want) and one_minus == float(1.0 - want), g


@pytest.fixture(scope="module")
def narrow():
    """(flax net, seeded flax variables) of the narrow x2 RRDBNet."""
    jm = JaxRRDBNet(JaxRRDBConfig(**NARROW))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))
    return jm, seeded_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), 50, gain=1.0)


def port_net(variables):
    net = RRDBNet(RRDBConfig(**NARROW))
    from_jax.load_jax_variables(net, variables)
    return net


def _close(net, tree, atol, what=""):
    want = from_jax.from_jax_variables(jax.tree.map(np.asarray, tree))
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=atol, err_msg=f"{what}{name}")


def test_one_sgd_step_matches_jax(narrow):
    jm, variables = narrow
    rng = np.random.default_rng(6)
    hr = rng.random((2, 16, 16, 3), np.float32)
    lr = hr[:, ::2, ::2].copy()
    tx = optax.sgd(0.05)
    new, _, want = jst.make_sr_train_step(jm, tx)(variables, tx.init(variables), jnp.asarray(lr), jnp.asarray(hr))
    net = port_net(variables)
    got = tst.make_sr_train_step(net, torch.optim.SGD(net.parameters(), lr=0.05))(torch.from_numpy(lr), torch.from_numpy(hr))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _close(net, new, 1e-6)


def test_clip_and_adam_match_optax_on_given_gradients():
    """sr_golden_train's optimizer: clip at 5, Adam (no weight decay) on a
    warmup-cosine schedule; gradients above and below the clip."""
    rng = np.random.default_rng(7)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((3, 3, 4), (4,))]
    grads = [[(rng.standard_normal(p.shape) * s).astype(np.float32) for p in params] for s in (10.0, 0.1, 3.0)]
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 10, 5e-4)))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = ClippedAdamW(tp, WarmupCosineDecay(1e-2, 1, 10, 5e-4), weight_decay=0.0, max_norm=5.0)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6)


def _staged(n_staged=3, b=2, seed=8):
    rng = np.random.default_rng(seed)
    hr_u8 = rng.integers(0, 256, (n_staged, b, 16, 16, 3), dtype=np.uint8)
    return np.ascontiguousarray(hr_u8[:, :, ::2, ::2]), hr_u8


def test_staged_loop_without_flip_is_the_single_steps(narrow):
    _, variables = narrow
    lr_u8, hr_u8 = _staged()
    ref = port_net(variables)
    step = tst.make_sr_train_step(ref, torch.optim.SGD(ref.parameters(), lr=0.05))
    for i in range(4):
        step(torch.from_numpy(lr_u8[(2 + i) % 3]).float() * (1.0 / 255.0),
             torch.from_numpy(hr_u8[(2 + i) % 3]).float() * (1.0 / 255.0))
    net = port_net(variables)
    ema = copy.deepcopy(net)
    run = tst.make_sr_staged_loop(net, torch.optim.SGD(net.parameters(), lr=0.05), steps_per_dispatch=4, flip=False,
                                  ema_decay=0.5)
    loss = run(ema, torch.from_numpy(lr_u8), torch.from_numpy(hr_u8), start=2)
    assert np.isfinite(float(loss))
    for (name, a), b in zip(net.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(a, b), name
    p0, pn, em = (m.conv_first.weight.detach() for m in (port_net(variables), net, ema))
    assert not torch.allclose(em, p0) and not torch.allclose(em, pn)


def test_staged_loop_with_jax_flips_matches_the_jax_loop(narrow):
    """Three steps from global step 5 (the EMA warmup in force), each batch
    flipped where JAX's ``bernoulli(fold_in(key, i))`` says."""
    jm, variables = narrow
    lr_u8, hr_u8 = _staged(seed=9)
    key, steps, start = jax.random.PRNGKey(4), 3, 5
    tx = optax.sgd(0.05)
    run = jst.make_sr_staged_loop(jm, tx, steps_per_dispatch=steps, flip=True, ema_decay=0.999)
    new, ema_want, _, want = run(variables, variables, tx.init(variables), jnp.asarray(lr_u8), jnp.asarray(hr_u8),
                                 jnp.int32(start), key)
    flips = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), shape=(2,))) for i in range(steps)])
    assert flips.any() and not flips.all()
    net = port_net(variables)
    ema = copy.deepcopy(net)
    loop = tst.make_sr_staged_loop(net, torch.optim.SGD(net.parameters(), lr=0.05), steps_per_dispatch=steps)
    got = loop(ema, torch.from_numpy(lr_u8), torch.from_numpy(hr_u8), start=start, flips=flips)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _close(net, new, 1e-6, "params ")
    _close(ema, ema_want, 1e-6, "ema ")
