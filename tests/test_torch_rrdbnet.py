"""The port's RRDBNet (facedet_tpu_torch/models/rrdbnet.py) against the flax
net on the CPU, with the weights carried across by models/from_jax.py.

Tolerance: float32 on both sides. Tiny nets agree within 1e-5 on outputs of
order 1; the full-width golden nets (23 blocks, 345 convs in sequence)
within 1e-4 on [0, 1]: convs sum in another order in the two frameworks.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.engine.detector import load_params_npz as jax_load_params_npz
from facedet_tpu.models import rrdbnet as jax_rrdb
from facedet_tpu_torch.models import rrdbnet as rrdb
from facedet_tpu_torch.models.from_jax import load_jax_variables, load_rrdb_npz

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "facedet_tpu", "eval", "assets")


def _flax_tree(variables) -> dict:
    return jax.tree.map(np.asarray, jax.device_get(variables))


def _pair(scale: int, seed: int = 0, **kw):
    """A flax net with random weights (biases too) and the port's net
    holding the same weights."""
    dims = dict(num_feat=8, num_block=1, num_grow_ch=4)
    dims.update(kw)
    jmodel, variables = jax_rrdb.create_rrdbnet(jax_rrdb.RRDBConfig(scale=scale, **dims), jax.random.PRNGKey(seed), 16)
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), _flax_tree(variables))
    model = rrdb.RRDBNet(rrdb.RRDBConfig(scale=scale, **dims)).eval()
    load_jax_variables(model, variables)
    return jmodel, variables, model


@pytest.mark.parametrize("factor", [2, 4])
def test_pixel_unshuffle_matches_flax_channel_order(factor):
    x = np.random.default_rng(factor).normal(size=(2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(jax_rrdb.pixel_unshuffle(jnp.asarray(x), factor))
    got = rrdb.pixel_unshuffle(torch.from_numpy(x), factor).numpy()
    np.testing.assert_array_equal(got, want)
    nchw = rrdb.pixel_unshuffle_nchw(torch.from_numpy(x).permute(0, 3, 1, 2), factor)
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), want)
    # torch's own unshuffle orders the channels otherwise: the hazard
    theirs = torch.nn.functional.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), factor)
    assert not np.array_equal(theirs.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("scale,hw", [(4, (8, 12)), (2, (8, 12)), (1, (8, 12)), (4, (5, 7)), (2, (10, 6))])
def test_tiny_net_matches_flax(scale, hw):
    jmodel, variables, model = _pair(scale, seed=scale)
    x = np.random.default_rng(1).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, hw[0] * scale, hw[1] * scale, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_two_blocks_and_wider_growth_match_flax():
    jmodel, variables, model = _pair(4, seed=7, num_feat=16, num_block=2, num_grow_ch=8)
    x = np.random.default_rng(2).uniform(0, 1, (1, 6, 6, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name,ckpt", [("RealESRGAN_x2plus", "rrdb_x2_golden.npz"), ("RealESRGAN_x4plus", "rrdb_x4gan_golden.npz")])
def test_golden_full_width_forward_matches_flax(name, ckpt):
    """The catalog's 23-block, 64-feature nets with the committed weights
    on a 16x16 input. The x2 net closes the pixel-unshuffle hazard: with
    torch's channel order its output is another picture."""
    path = os.path.join(ASSETS, ckpt)
    x = np.random.default_rng(5).uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    variables = jax_load_params_npz(path)
    want = np.asarray(jax_rrdb.RRDBNet(jax_rrdb.MODEL_CATALOG[name]).apply(variables, jnp.asarray(x)))
    cfg = rrdb.MODEL_CATALOG[name]
    assert (cfg.num_feat, cfg.num_block, cfg.num_grow_ch) == (64, 23, 32)
    model = rrdb.RRDBNet(cfg).eval()
    load_rrdb_npz(model, path)
    assert sum(p.numel() for p in model.parameters()) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 16 * cfg.scale, 16 * cfg.scale, 3)
    err = float(np.abs(got - want).max())
    print(f"{name}: max abs err against flax {err:.3g}")
    assert err <= 1e-4, err


def test_catalog_and_config_match_flax():
    assert set(rrdb.MODEL_CATALOG) == set(jax_rrdb.MODEL_CATALOG)
    for name, cfg in rrdb.MODEL_CATALOG.items():
        theirs = jax_rrdb.MODEL_CATALOG[name]
        for f in ("num_in_ch", "num_out_ch", "scale", "num_feat", "num_block", "num_grow_ch", "dtype"):
            assert getattr(cfg, f) == getattr(theirs, f), (name, f)
    assert rrdb.LRELU_SLOPE == jax_rrdb.LRELU_SLOPE == 0.2
    assert rrdb.RRDBConfig(dtype="bfloat16").compute_dtype == torch.bfloat16


def test_checkpoint_of_another_net_is_refused():
    model = rrdb.RRDBNet(rrdb.MODEL_CATALOG["RealESRGAN_x2plus"])
    with pytest.raises((RuntimeError, KeyError)):
        load_rrdb_npz(model, os.path.join(ASSETS, "rrdb_x4_golden.npz"))  # conv_first takes 3 planes, not 12
    tiny = rrdb.RRDBNet(rrdb.RRDBConfig(num_feat=8, num_block=1, num_grow_ch=4))
    with pytest.raises(KeyError, match="do not match"):
        load_rrdb_npz(tiny, os.path.join(ASSETS, "rrdb_x4_golden.npz"))


def test_bfloat16_net_stays_close_to_float32():
    """The serving dtype: parameters cast once, bfloat16 activations and
    residual adds, float32 output. Held by PSNR, not element-wise."""
    _, variables, model = _pair(4, seed=3)
    half = rrdb.RRDBNet(rrdb.RRDBConfig(scale=4, num_feat=8, num_block=1, num_grow_ch=4, dtype="bfloat16")).eval()
    load_jax_variables(half, variables)
    half.set_dtypes()
    assert half.conv_first.weight.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (1, 8, 8, 3)).astype(np.float32))
    with torch.inference_mode():
        a, b = model(x), half(x)
    assert b.dtype == torch.float32
    mse = float(((a - b) ** 2).mean())
    assert 10 * np.log10(float(a.abs().max()) ** 2 / mse) > 30.0


def test_create_rrdbnet_is_seeded():
    cfg = rrdb.RRDBConfig(num_feat=8, num_block=1, num_grow_ch=4)
    a = rrdb.create_rrdbnet(cfg, torch.Generator().manual_seed(3))
    b = rrdb.create_rrdbnet(cfg, torch.Generator().manual_seed(3))
    c = rrdb.create_rrdbnet(cfg, torch.Generator().manual_seed(4))
    assert torch.equal(a.conv_first.weight, b.conv_first.weight)
    assert not torch.equal(a.conv_first.weight, c.conv_first.weight)
    assert float(a.conv_first.bias.detach().abs().max()) == 0.0
