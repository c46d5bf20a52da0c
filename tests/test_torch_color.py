"""The port's YUV420 colour ops (facedet_tpu_torch/ops/color.py) against the
JAX package's (facedet_tpu/ops/color.py) on the CPU, on seeded numpy inputs.

Tolerances: the host functions are copies and must give equal arrays
(``array_equal``). ``yuv420_to_rgb_f32`` in float32: 1e-5 on [0, 1] (the
two frameworks sum the 3-term colour product and the upsample's two-term
blends in their own order). In bfloat16: 3 bfloat16 steps at 1.0
(3 * 2**-8): XLA and eager PyTorch round to bfloat16 at different points of
the upsample -> subtract -> product -> divide chain.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.ops import color as jcolor
from facedet_tpu_torch.ops import color as tcolor

torch.set_num_threads(1)

F32_ATOL = 1e-5
BF16_ATOL = 3 * 2.0**-8


def natural_image(h, w, seed=0):
    """tests/test_color.py's image: smooth noise at three scales."""
    rng = np.random.default_rng(seed)
    base = np.zeros((h, w), np.float32)
    for octave in (4, 16, 64):
        up = np.kron(
            rng.standard_normal((octave, octave)).astype(np.float32),
            np.ones((-(-h // octave), -(-w // octave)), np.float32),
        )[:h, :w]
        base += up / octave**0.5
    base = (base - base.min()) / (base.max() - base.min())
    return np.stack([base * 255, base * 200 + 30, 255 - base * 220], -1).astype(np.uint8)


def test_matrices_and_byte_count_equal():
    np.testing.assert_array_equal(tcolor._FWD, jcolor._FWD)
    np.testing.assert_array_equal(tcolor._INV, jcolor._INV)
    for hw in ((256, 512), (33, 47), (1024, 1536)):
        assert tcolor.yuv420_bytes(*hw) == jcolor.yuv420_bytes(*hw)
    assert tcolor.yuv420_bytes(256, 512) == 256 * 512 * 3 // 2


@pytest.mark.parametrize("hw", [(64, 96), (33, 47), (90, 130)])
def test_rgb_to_yuv420_equals_jax_host_function(hw):
    img = natural_image(*hw, seed=sum(hw))
    y, uv = tcolor.rgb_to_yuv420(img)
    jy, juv = jcolor.rgb_to_yuv420(img)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(uv, juv)
    assert y.shape == hw and uv.shape == ((hw[0] + 1) // 2, (hw[1] + 1) // 2, 2)
    # a float image is clipped and cast first, as in the reference
    f = img.astype(np.float32) * 1.2 - 10.0
    for a, b in zip(tcolor.rgb_to_yuv420(f), jcolor.rgb_to_yuv420(f)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(96, 128), (33, 47)])
def test_yuv420_to_rgb_np_equals_jax_host_function(hw):
    img = natural_image(*hw, seed=1)
    y, uv = tcolor.rgb_to_yuv420(img)
    back = tcolor.yuv420_to_rgb_np(y, uv)
    np.testing.assert_array_equal(back, jcolor.yuv420_to_rgb_np(y, uv))
    assert back.shape == img.shape
    if hw == (96, 128):  # tests/test_color.py:49-54: only the chroma subsampling is lost
        assert np.abs(back.astype(np.float32) - img.astype(np.float32)).mean() < 3.0


@pytest.mark.parametrize("hw", [(64, 96), (128, 256)])
@pytest.mark.parametrize("as_float", [False, True])
def test_device_conversion_float32_matches_jax(hw, as_float):
    img = natural_image(*hw, seed=3)
    y, uv = tcolor.rgb_to_yuv420(img)
    if as_float:
        y, uv = y.astype(np.float32), uv.astype(np.float32)
    want = np.asarray(jcolor.yuv420_to_rgb_f32(jnp.asarray(y), jnp.asarray(uv)))
    got = tcolor.yuv420_to_rgb_f32(torch.from_numpy(y), torch.from_numpy(uv))
    assert got.shape == (*hw, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_device_conversion_matches_host_reconstruction():
    """tests/test_color.py:57-65: bilinear (device) against nearest (host)
    chroma upsampling of the same planes."""
    img = natural_image(64, 96, seed=3)
    y, uv = tcolor.rgb_to_yuv420(img)
    dev = tcolor.yuv420_to_rgb_f32(torch.from_numpy(y), torch.from_numpy(uv)).numpy() * 255.0
    host = tcolor.yuv420_to_rgb_np(y, uv).astype(np.float32)
    assert np.abs(dev - host).mean() < 5.0
    assert dev.min() >= 0.0 and dev.max() <= 255.0


def test_device_conversion_odd_chroma_ratio_takes_resize_weights():
    """Chroma planes that are not exactly half size go through
    ``jax.image.resize``'s linear weights in both packages."""
    img = natural_image(33, 47, seed=5)
    y, uv = tcolor.rgb_to_yuv420(img)  # uv is (17, 24): not half of (33, 47)
    want = np.asarray(jcolor.yuv420_to_rgb_f32(jnp.asarray(y), jnp.asarray(uv)))
    got = tcolor.yuv420_to_rgb_f32(torch.from_numpy(y), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_device_conversion_bfloat16_within_stated_steps():
    img = natural_image(64, 96, seed=7)
    y, uv = tcolor.rgb_to_yuv420(img)
    want = np.asarray(
        jcolor.yuv420_to_rgb_f32(jnp.asarray(y), jnp.asarray(uv), out_dtype=jnp.bfloat16).astype(jnp.float32)
    )
    got = tcolor.yuv420_to_rgb_f32(torch.from_numpy(y), torch.from_numpy(uv), out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL, rtol=0)
    # and bfloat16 stays near the float32 result: half a pixel level of 255
    # from each of the rounded stages
    f32 = tcolor.yuv420_to_rgb_f32(torch.from_numpy(y), torch.from_numpy(uv)).numpy()
    assert np.abs(got.float().numpy() - f32).max() <= 4 * 2.0**-8


def test_batch_axis_and_channel_first_layout():
    imgs = [natural_image(32, 48, seed=s) for s in range(3)]
    planes = [tcolor.rgb_to_yuv420(im) for im in imgs]
    y = torch.from_numpy(np.stack([p[0] for p in planes]))
    uv = torch.from_numpy(np.stack([p[1] for p in planes]))
    batched = tcolor.yuv420_to_rgb_f32(y, uv)
    chw = tcolor.yuv420_to_rgb_chw(y, uv)
    assert batched.shape == (3, 32, 48, 3) and chw.shape == (3, 3, 32, 48) and chw.is_contiguous()
    for i, (yi, uvi) in enumerate(planes):
        single = tcolor.yuv420_to_rgb_f32(torch.from_numpy(yi), torch.from_numpy(uvi))
        np.testing.assert_allclose(batched[i].numpy(), single.numpy(), atol=1e-7, rtol=0)
        np.testing.assert_array_equal(chw[i].permute(1, 2, 0).numpy(), batched[i].numpy())
