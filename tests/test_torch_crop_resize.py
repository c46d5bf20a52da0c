"""The port's image ops for the enhancement path against ``jax.image`` and
the JAX package on the CPU: ``crop_and_resize`` / ``paste_resized_crops``
(ops/crop_resize.py), the Lanczos resize and the reflect padding
(ops/image.py).

Tolerance: float32 on both sides. The weight matrices agree within 1e-6
(``sin`` and the divisions differ in the last bit between XLA and torch), and
a resampled pixel is a sum of up to a few hundred weighted values in [0, 1]:
1e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.ops.crop_resize import crop_and_resize as jax_crop_and_resize
from facedet_tpu.ops.crop_resize import paste_resized_crops as jax_paste_resized_crops
from facedet_tpu_torch.ops.crop_resize import crop_and_resize, crop_and_resize_chw, paste_resized_crops
from facedet_tpu_torch.ops.image import compute_weight_mat, reflect_pad, resize_chw

torch.set_num_threads(1)

BOXES = {
    "inside": [[10.0, 12.0, 40.0, 44.0], [30.5, 8.25, 50.75, 20.0]],
    "across_the_border": [[-8.0, -5.0, 20.0, 18.0], [70.0, 40.0, 110.0, 75.0], [-30.0, 20.0, -2.0, 50.0]],
    "larger_than_out_size": [[2.0, 1.0, 92.0, 62.0], [0.0, 0.0, 96.0, 64.0]],
    "degenerate": [[20.0, 20.0, 20.0, 20.0], [0.0, 0.0, 0.0, 0.0], [50.0, 40.0, 30.0, 10.0], [1e6, 1e6, 1e6 + 1, 1e6 + 1]],
}


def _image(h=64, w=96, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("margin", [0.0, 0.1])
@pytest.mark.parametrize("case", sorted(BOXES))
def test_crop_and_resize_matches_jax(case, margin):
    img = _image()
    boxes = np.array(BOXES[case], np.float32)
    want = np.asarray(jax_crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), out_size=16, margin=margin))
    got = crop_and_resize(torch.from_numpy(img), torch.from_numpy(boxes), out_size=16, margin=margin)
    assert got.shape == (len(boxes), 16, 16, 3)
    assert torch.isfinite(got).all()  # arbitrary boxes of invalid rows: no NaN escapes
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_crop_and_resize_chunks_and_empty():
    """More boxes than one chunk of the batched product, and none."""
    img = _image(seed=1)
    rng = np.random.default_rng(2)
    xy = rng.uniform(-10, 80, (150, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(1, 60, (150, 2)).astype(np.float32)], 1)
    want = np.asarray(jax_crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), out_size=8, margin=0.05))
    got = crop_and_resize(torch.from_numpy(img), torch.from_numpy(boxes), out_size=8, margin=0.05).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    none = crop_and_resize_chw(torch.from_numpy(img).permute(2, 0, 1), torch.zeros((0, 4)), out_size=8)
    assert none.shape == (0, 3, 8, 8)


def test_paste_resized_crops_matches_jax():
    rng = np.random.default_rng(3)
    crops = rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    boxes = np.array([[2.0, 3.0, 20.0, 17.0], [-4.0, 10.0, 9.0, 40.0], [30.0, 30.0, 30.0, 35.0]], np.float32)
    want = jax_paste_resized_crops(jnp.asarray(crops), jnp.asarray(boxes), (32, 40))
    got = paste_resized_crops(torch.from_numpy(crops), torch.from_numpy(boxes), (32, 40))
    assert got.dtype == np.uint8 and got.shape == (32, 40, 3)
    # the float canvas is truncated to uint8, so a last-bit difference may move a level
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != want).mean() < 0.01


@pytest.mark.parametrize("src,dst", [((24, 36), (48, 72)), ((48, 72), (24, 36)), ((20, 31), (33, 17)), ((16, 16), (16, 40))])
def test_lanczos3_resize_matches_jax(src, dst):
    """Up, down (antialiased: the kernel is widened), mixed, and one axis
    left alone, as FaceEnhancer uses it for an outscale other than the net's."""
    img = _image(*src, seed=4)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (*dst, 3), method="lanczos3"))
    got = resize_chw(torch.from_numpy(img).permute(2, 0, 1), *dst, method="lanczos3").permute(1, 2, 0).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - img.mean()).max() > 0.1  # not a constant image


@pytest.mark.parametrize("kernel", ["linear", "lanczos3"])
def test_weight_matrix_matches_jax(kernel):
    from jax._src.image import scale as jax_scale

    for n_in, n_out in ((12, 30), (30, 12), (7, 7)):
        want = np.asarray(jax_scale.compute_weight_mat(
            n_in, n_out, n_out / n_in, 0.0, jax_scale._kernels[jax_scale.ResizeMethod.from_string(kernel)], True
        ))
        got = compute_weight_mat(n_in, n_out, n_out / n_in, kernel=kernel).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("pads", [((0, 12), (0, 22)), ((3, 4), (5, 6)), ((10, 37), (9, 2)), ((0, 0), (0, 1))])
def test_reflect_pad_matches_jnp_pad(pads):
    """jnp.pad reflects again and again where the pad exceeds the axis (a
    10-pixel crop padded to its 32 bucket); F.pad(mode="reflect") raises there."""
    x = np.random.default_rng(5).uniform(0, 1, (10, 9, 3)).astype(np.float32)
    want = np.asarray(jnp.pad(jnp.asarray(x), (*pads, (0, 0)), mode="reflect"))
    got = reflect_pad(torch.from_numpy(x), {0: pads[0], 1: pads[1]}).numpy()
    np.testing.assert_array_equal(got, want)
    if pads[1][1] >= 9:
        with pytest.raises(RuntimeError):
            torch.nn.functional.pad(torch.from_numpy(x).permute(2, 0, 1), (0, pads[1][1], 0, pads[0][1]), mode="reflect")


def test_reflect_pad_of_a_single_sample_axis():
    x = torch.arange(4.0).reshape(1, 4)
    np.testing.assert_array_equal(
        reflect_pad(x, {0: (2, 3)}).numpy(), np.pad(x.numpy(), ((2, 3), (0, 0)), mode="reflect")
    )
