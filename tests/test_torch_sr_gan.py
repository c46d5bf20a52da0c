"""The port's GAN arm (facedet_tpu_torch/train/sr_gan.py) and perceptual
loss (train/perceptual.py) against facedet_tpu/train/sr_gan.py and
perceptual.py on the CPU, float32, with flax's variables carried across
(``models/from_jax.load_discriminator_variables`` for the discriminator).

Tolerances: the spectral-norm conv's ``u`` and sigma within 1e-6 and its
output within 1e-5 after a train call, an eval call and two successive
train calls from flax's ``u``, its gradients on the kernel, the bias and
the input within 1e-5 of each one's largest; ``PatchDiscriminator(base=8)``
logits within 1e-5 at an even and an odd size; the golden-yolo11n
perceptual loss within 1e-5 relative and its input gradient within 1e-4 of
the largest (a whole backbone: the convs sum in another order); three
staged GAN steps (SGD) fed JAX's flip draws against the JAX loop, with and
without the perceptual term and resumed at global step 3: the four mean
metrics within 1e-5 relative (1e-4 with the perceptual term), G, its EMA
and D within 1e-5, D's ``u`` and sigma within 1e-5.
"""
import copy
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facedet_tpu.models.rrdbnet import RRDBConfig as JaxRRDBConfig
from facedet_tpu.models.rrdbnet import RRDBNet as JaxRRDBNet
from facedet_tpu.train import perceptual as jper
from facedet_tpu.train import sr_gan as jgan
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models.rrdbnet import RRDBConfig, RRDBNet
from facedet_tpu_torch.train import perceptual as tper
from facedet_tpu_torch.train import sr_gan as tgan
from test_torch_scrfd import seeded_variables

torch.set_num_threads(1)


class FlaxSNConv(fnn.Module):
    """flax's ``SpectralNorm(Conv)`` as the discriminator builds it."""

    features: int
    kernel: int
    stride: int

    @fnn.compact
    def __call__(self, x, train: bool):
        conv = fnn.Conv(self.features, (self.kernel, self.kernel), strides=(self.stride, self.stride), padding="SAME",
                        name="c")
        return fnn.SpectralNorm(conv)(x, update_stats=train)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _port_sn(variables, cin, feat, k, s):
    m = tgan.SpectralNormConv2d(cin, feat, k, s)
    state = from_jax.from_jax_variables({"params": variables["params"]["c"]})
    stats = variables["batch_stats"]["SpectralNorm_0"]
    state.update(u=torch.from_numpy(np.array(stats["c/kernel/u"])), sigma=torch.from_numpy(np.array(stats["c/kernel/sigma"])))
    m.load_state_dict(state)
    return m


@pytest.mark.parametrize("cin,feat,k,s,hw", [(3, 8, 3, 1, (12, 12)), (8, 16, 4, 2, (12, 12)), (8, 16, 4, 2, (11, 13))],
                         ids=["3x3", "4x4-stride2", "4x4-stride2-odd"])
def test_spectral_norm_conv_matches_flax(cin, feat, k, s, hw):
    rng = np.random.default_rng(k * 10 + hw[1])
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    fm = FlaxSNConv(feat, k, s)
    variables = jax.tree.map(np.asarray, jax.jit(fm.init, static_argnames="train")(jax.random.PRNGKey(k), jnp.asarray(x), train=False))
    variables["params"]["c"]["bias"] = rng.standard_normal(feat).astype(np.float32) * 0.1
    stats_key = "SpectralNorm_0"
    assert set(variables["batch_stats"][stats_key]) == {"c/kernel/u", "c/kernel/sigma"}
    m = _port_sn(variables, cin, feat, k, s)

    def flax_call(params, stats, x, train):
        return fm.apply({"params": params, "batch_stats": stats}, x, train=train, mutable=["batch_stats"])

    def check(y, state, got, what):
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y), atol=1e-5, err_msg=what)
        st = state["batch_stats"][stats_key]
        np.testing.assert_allclose(m.u.numpy(), np.asarray(st["c/kernel/u"]), atol=1e-6, err_msg=what)
        np.testing.assert_allclose(float(m.sigma), float(st["c/kernel/sigma"]), rtol=1e-6, err_msg=what)

    stats = variables["batch_stats"]
    y, state = flax_call(variables["params"], stats, x, False)  # eval: the power step runs, nothing is stored
    got = m.eval()(_nchw(x))
    check(y, state, got, "eval")
    np.testing.assert_array_equal(m.u.numpy(), stats[stats_key]["c/kernel/u"])
    for i in range(2):  # two successive train calls, as in the D step
        y, state = flax_call(variables["params"], stats, x, True)
        got = m.train()(_nchw(x))
        check(y, state, got, f"train call {i}")
        stats = state["batch_stats"]
    assert float(m.sigma) != 1.0

    cot = rng.standard_normal(np.asarray(y).shape).astype(np.float32)

    def f(params, x):
        return jnp.sum(flax_call(params, stats, x, True)[0] * cot)

    g_params, g_x = jax.grad(f, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    m2 = _port_sn({"params": variables["params"], "batch_stats": stats}, cin, feat, k, s).train()
    xt = _nchw(x).requires_grad_()
    (m2(xt) * _nchw(cot)).sum().backward()
    want = from_jax.from_jax_variables({"params": jax.tree.map(np.asarray, g_params)})
    for got_g, w in ((m2.weight.grad, want["c.weight"]), (m2.bias.grad, want["c.bias"]), (xt.grad, _nchw(np.asarray(g_x)))):
        np.testing.assert_allclose(got_g.numpy(), w.numpy(), rtol=0, atol=1e-5 * float(w.abs().max()))


def discriminator_pair(hr=32, seed=1):
    jd = jgan.PatchDiscriminator(base=8)
    variables = jax.tree.map(np.asarray, jax.jit(jd.init)(jax.random.PRNGKey(seed), jnp.zeros((1, hr, hr, 3))))
    d = tgan.PatchDiscriminator(8)
    from_jax.load_discriminator_variables(d, variables)
    return jd, variables, d


@pytest.mark.parametrize("hw", [(32, 32), (30, 27)])
def test_patch_discriminator_matches_flax(hw):
    jd, variables, d = discriminator_pair()
    x = np.random.default_rng(hw[1]).random((2, *hw, 3), np.float32)
    want = jd.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = d.eval()(torch.from_numpy(x))
    assert got.shape == want.shape == (2, -(-hw[0] // 8), -(-hw[1] // 8), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(RuntimeError, match="size mismatch"):
        from_jax.load_discriminator_variables(tgan.PatchDiscriminator(16), variables)
    stats = dict(variables["batch_stats"])
    del stats["SpectralNorm_3"]
    with pytest.raises(KeyError, match="missing"):
        from_jax.load_discriminator_variables(tgan.PatchDiscriminator(8), {**variables, "batch_stats": stats})


def test_perceptual_loss_and_its_input_gradient_match_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32) for _ in range(2))
    jloss = jper.make_yolo_feature_loss()
    want, want_g = jax.jit(jax.value_and_grad(lambda x: jloss(x, jnp.asarray(b))))(jnp.asarray(a))
    loss = tper.make_yolo_feature_loss(device="cpu")
    at = torch.from_numpy(a).requires_grad_()
    got = loss(at, torch.from_numpy(b))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    w = np.asarray(want_g)
    np.testing.assert_allclose(at.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    assert float(loss(torch.from_numpy(a), torch.from_numpy(a))) < 1e-6
    assert os.path.samefile(tper.GOLDEN_YOLO, jper.GOLDEN_YOLO)


@pytest.fixture(scope="module")
def gan_setup():
    """A narrow x2 G (seeded), D base 8 (flax's init), staged uint8 pairs at
    HR 32 (the perceptual backbone needs multiples of 32)."""
    jg = JaxRRDBNet(JaxRRDBConfig(scale=2, num_block=1, num_feat=8, num_grow_ch=4))
    shapes = jax.eval_shape(lambda: jg.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    g_vars = seeded_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), 60, gain=1.0)
    jd, d_vars, _ = discriminator_pair()
    rng = np.random.default_rng(0)
    lr_u8 = rng.integers(0, 256, (3, 2, 16, 16, 3), dtype=np.uint8)
    hr_u8 = rng.integers(0, 256, (3, 2, 32, 32, 3), dtype=np.uint8)
    return jg, g_vars, jd, d_vars, lr_u8, hr_u8


def _port_gan(g_vars, d_vars):
    g = RRDBNet(RRDBConfig(scale=2, num_block=1, num_feat=8, num_grow_ch=4))
    from_jax.load_jax_variables(g, g_vars)
    d = tgan.PatchDiscriminator(8)
    from_jax.load_discriminator_variables(d, d_vars)
    return g, d


def _check_state(g, ema, d, out, what, atol=1e-5):
    g_vars, g_ema, _, d_params, d_stats, _, _ = out
    for net, tree, label in ((g, g_vars, "G"), (ema, g_ema, "EMA")):
        want = from_jax.from_jax_variables(jax.tree.map(np.asarray, tree))
        for name, p in net.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=atol, err_msg=f"{what} {label} {name}")
    want = from_jax.from_jax_variables({"params": jax.tree.map(np.asarray, d_params)})
    for name, p in d.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=atol, err_msg=f"{what} D {name}")
    for stats in d_stats.values():
        for key, arr in stats.items():
            conv, _, leaf = key.split("/")
            np.testing.assert_allclose(getattr(d, conv).state_dict()[leaf].numpy(), np.asarray(arr), rtol=0, atol=atol,
                                       err_msg=f"{what} D {key}")


@pytest.mark.parametrize("percep", [False, True], ids=["pixel-adv", "with-perceptual"])
def test_gan_staged_loop_matches_the_jax_loop(gan_setup, percep):
    jg, g_vars, jd, d_vars, lr_u8, hr_u8 = gan_setup
    lr, steps, key = 0.05, 3, jax.random.PRNGKey(2)
    g_tx, d_tx = optax.sgd(lr), optax.sgd(lr)
    kw = dict(percep_fn=jper.make_yolo_feature_loss(), percep_weight=0.5) if percep else {}
    run = jgan.make_sr_gan_staged_loop(jg, jd, g_tx, d_tx, steps_per_dispatch=steps, flip=True, **kw)
    args = (g_vars, g_vars, g_tx.init(g_vars), d_vars["params"], d_vars["batch_stats"], d_tx.init(d_vars["params"]))

    g, d = _port_gan(g_vars, d_vars)
    ema = copy.deepcopy(g)
    tkw = dict(percep_fn=tper.make_yolo_feature_loss(device="cpu"), percep_weight=0.5) if percep else {}
    loop = tgan.make_sr_gan_staged_loop(g, d, torch.optim.SGD(g.parameters(), lr=lr),
                                        torch.optim.SGD(d.parameters(), lr=lr), steps_per_dispatch=steps, flip=True, **tkw)
    rtol = 1e-4 if percep else 1e-5
    for start in ((0, 3) if not percep else (0,)):  # the resume at a global step, as tests/test_sr_gan.py:66
        k = jax.random.fold_in(key, start)
        out = run(*args, jnp.asarray(lr_u8), jnp.asarray(hr_u8), jnp.int32(start), k)
        flips = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(k, i), shape=(2,))) for i in range(steps)])
        metrics = loop(ema, torch.from_numpy(lr_u8), torch.from_numpy(hr_u8), start=start, flips=flips)
        assert set(metrics) == set(out[-1]) == {"pixel", "adv", "percep", "d"}
        for name, v in out[-1].items():
            np.testing.assert_allclose(float(metrics[name]), float(v), rtol=rtol, atol=1e-7, err_msg=f"{start} {name}")
        assert (float(metrics["percep"]) > 0) == percep
        _check_state(g, ema, d, out, f"from step {start}")
        args = out[:6]
