"""The port's TOPIQ / CFANet (facedet_tpu_torch/models/topiq.py) against the
JAX package's flax module on the CPU, and the torch mirror's state dict.

Tolerances: float32 scores within 2e-5 of flax (convs and attention sum in
another order) at 64x64 and at sizes whose scales pool to other token
counts; the mirror of tests/torch_topiq_ref.py within 2e-5; bfloat16 against
flax's bfloat16 within 2e-2 (both round every conv and linear to 8 bits of
mantissa, in different places). Shapes, names and parameter counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.models import topiq as jtopiq
from facedet_tpu_torch.models import topiq as ttopiq
from facedet_tpu_torch.models.from_jax import load_topiq_variables

torch.set_num_threads(1)

TINY = dict(embed_dim=32, num_heads=2, num_attn_blocks=1, mlp_ratio=2.0, stage_channels=(8, 16, 32, 64),
            stage_depths=(1, 1, 1, 1))


def flax_variables(cfg, seed=0, size=64):
    """Flax init with spread BatchNorm statistics, so that the running-average
    path is exercised; numpy leaves."""
    variables = jax.tree_util.tree_map(np.asarray, jtopiq.CFANet(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.default_rng(seed)

    def spread(node):
        for k, v in node.items():
            if isinstance(v, dict):
                spread(v)
            elif k == "mean":
                node[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    variables = {k: dict(v) for k, v in variables.items()}
    spread(variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def tiny_pair():
    variables = flax_variables(jtopiq.TopiqConfig(**TINY))
    model = ttopiq.CFANet(ttopiq.TopiqConfig(**TINY))
    load_topiq_variables(model, variables)
    return variables, model.eval()


@pytest.mark.parametrize("hw", [(64, 64), (100, 100), (72, 104)])
def test_carried_flax_variables_match_flax(tiny_pair, hw):
    variables, model = tiny_pair
    x = np.random.default_rng(hw[0]).random((2, *hw, 3), np.float32)
    want = np.asarray(jtopiq.CFANet(jtopiq.TopiqConfig(**TINY)).apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert np.ptp(got) > 1e-4  # the two images score apart


def test_scales_pool_to_flax_token_counts_at_an_odd_size(tiny_pair):
    """The window f_h // g_h serves both axes, VALID: at 100x100 the maps are
    25, 13, 7 and 4 wide and give 16, 16, 49 and 16 tokens."""
    _, model = tiny_pair
    with torch.no_grad():
        feats = model.backbone(torch.zeros(1, 3, 100, 100))
    assert [f.shape[-1] for f in feats] == [25, 13, 7, 4]
    gh = feats[-1].shape[2]
    counts = []
    for f in feats:
        fh = f.shape[2] // gh
        counts.append((f.shape[2] // fh) * (f.shape[3] // fh))
    assert counts == [16, 16, 49, 16]


def test_bfloat16_against_flax_bfloat16(tiny_pair):
    variables, _ = tiny_pair
    cfg = dict(TINY, dtype="bfloat16")
    model = ttopiq.CFANet(ttopiq.TopiqConfig(**cfg))
    load_topiq_variables(model, variables)
    model.set_dtypes().eval()
    assert model.reduce0.weight.dtype == torch.bfloat16 and model.self0.attn.in_proj_weight.dtype == torch.bfloat16
    assert model.backbone.stem_bn.weight.dtype == torch.float32 and model.scale_embed0.dtype == torch.float32
    x = np.random.default_rng(5).random((2, 72, 104, 3), np.float32)
    want = np.asarray(jtopiq.CFANet(jtopiq.TopiqConfig(**cfg)).apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)


def test_torch_mirror_state_dict_loads_strictly():
    from tests.torch_topiq_ref import TorchCFANet

    torch.manual_seed(0)
    mirror = TorchCFANet(embed_dim=32, heads=2, num_attn_blocks=1, mlp_ratio=2.0, stage_channels=(8, 16, 32, 64),
                         stage_depths=(1, 1, 1, 1)).eval()
    for m in mirror.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.3)
            m.running_var.uniform_(0.5, 1.5)
    model = ttopiq.CFANet(ttopiq.TopiqConfig(**TINY)).eval()
    model.load_state_dict(mirror.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(1).random((2, 3, 80, 80), np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(model.forward_nchw(x).numpy(), mirror(x).numpy(), atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def full_width():
    return ttopiq.create_topiq(ttopiq.TopiqConfig(), torch.Generator().manual_seed(0), device="cpu")


def test_full_width_parameter_count_equals_flax(full_width):
    cfg = jtopiq.TopiqConfig()
    shapes = jax.eval_shape(lambda: jtopiq.CFANet(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                                                            train=False))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in full_width.parameters()) == want
    stats = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["batch_stats"]))
    assert sum(b.numel() for n, b in full_width.named_buffers() if not n.endswith("num_batches_tracked")) == stats


def test_full_width_keys_are_the_converter_layout(full_width):
    """The port's state dict is the layout ``convert_topiq_torch`` reads:
    the torch mirror's keys, and through the converter and back every value
    returns unchanged."""
    from tests.torch_topiq_ref import TorchCFANet

    sd = full_width.state_dict()
    assert list(sd) == list(TorchCFANet().state_dict())
    variables = jtopiq.convert_topiq_torch({k: v for k, v in sd.items() if "num_batches" not in k})
    shapes = jax.eval_shape(lambda: jtopiq.CFANet(jtopiq.TopiqConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    assert jax.tree.structure(variables) == jax.tree.structure(shapes)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(variables), jax.tree.leaves(shapes)))
    back = ttopiq.CFANet(ttopiq.TopiqConfig())
    load_topiq_variables(back, jax.tree_util.tree_map(np.asarray, variables))
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_full_width_forward_and_score_api(full_width):
    rng = np.random.default_rng(3)
    img = (rng.random((100, 100, 3)) * 255).astype(np.uint8)
    s = ttopiq.topiq_score(full_width, img)
    assert isinstance(s, float) and 0.05 < s < 0.95  # the seeded init does not saturate the sigmoid
    batch = rng.random((2, 96, 128, 3)).astype(np.float32)
    out = ttopiq.topiq_score(full_width, batch)
    assert out.shape == (2,) and np.isfinite(out).all()
    assert ttopiq.topiq_score(full_width, torch.from_numpy(batch[:1] * 255.0))[0] == pytest.approx(out[0], abs=1e-6)


def test_create_topiq_is_seeded():
    a = ttopiq.create_topiq(ttopiq.TopiqConfig(**TINY), torch.Generator().manual_seed(4), device="cpu")
    b = ttopiq.create_topiq(ttopiq.TopiqConfig(**TINY), torch.Generator().manual_seed(4), device="cpu")
    c = ttopiq.create_topiq(ttopiq.TopiqConfig(**TINY), torch.Generator().manual_seed(5), device="cpu")
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.reduce0.weight, c.reduce0.weight)
    assert torch.equal(a.self0.attn.in_proj_bias, torch.zeros_like(a.self0.attn.in_proj_bias))
    assert torch.equal(a.backbone.stem_bn.weight, torch.ones(64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttopiq.create_topiq(ttopiq.TopiqConfig(**TINY))  # the default device is the card
