"""facedet_tpu_torch/tools/profile_sr_layers.py against the JAX package on
the CPU, float32: the RDB as the tool times it (the port's
``ResidualDenseBlock``, concat then conv) against
facedet_tpu/models/rrdbnet.py's ``ResidualDenseBlock`` with its flax init
carried across, within 1e-5 (convs sum in other orders); ``rdb_sum``, the
same function as a sum of convs on weight slices, equal to it within float32
rounding (1e-5 of the output's largest); the elementwise baseline's value
exactly; and the FLOP counts the tool divides by.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.models.rrdbnet import ResidualDenseBlock as JaxRDB
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models.rrdbnet import ResidualDenseBlock
from facedet_tpu_torch.tools import profile_sr_layers as psl

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def carried():
    x = np.random.default_rng(0).standard_normal((1, 12, 16, 64)).astype(np.float32)
    jax_block = JaxRDB(64, 32)
    variables = jax.tree.map(np.asarray, jax_block.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    # flax's init leaves the biases 0: give them values, so the sum of convs adds each once
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.01 * (1 + np.arange(v.size, dtype=np.float32).reshape(v.shape) % 7)
        if p[-1].key == "bias" else v, variables)
    block = ResidualDenseBlock(64, 32)
    block.load_state_dict(from_jax.from_jax_variables(variables))
    want = np.asarray(jax_block.apply(variables, jnp.asarray(x)))
    return block.eval(), torch.from_numpy(x).permute(0, 3, 1, 2), want


def test_concat_rdb_matches_jax(carried):
    block, x, want = carried
    with torch.inference_mode():
        got = block(x).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_rdb_sum_equals_the_concat_rdb(carried):
    block, x, _ = carried
    with torch.inference_mode():
        a, b = block(x), psl.rdb_sum(block, x)
    assert not torch.equal(a, b)  # summed in another order
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5 * float(a.abs().max()))


def test_elementwise_baseline_value():
    x = torch.linspace(-3, 3, 61)
    want = np.where(x.numpy() * 0.2 + 0.1 > 0, 1.0, 0.2) * (x.numpy() * 0.2 + 0.1)
    np.testing.assert_allclose(psl.elementwise(x).numpy(), want.astype(np.float32), rtol=1e-6)


def test_rdb_flops_count_the_five_convs():
    assert psl.rdb_flops(512, 768) == 2 * 9 * 512 * 768 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64)
