"""The port's tile gather (facedet_tpu_torch/ops/kernels/tile_gather.py)
against the JAX package's XLA gather and its two Pallas kernels, run in
interpret mode as tests/test_pallas_gather.py runs them.

Tolerance: bit-exact (atol=0). A gather copies values; nothing is computed.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from facedet_tpu.ops.pallas.tile_gather import gather_tiles_pallas, gather_tiles_pallas_static
from facedet_tpu.ops.tiler import compute_slice_grid as jax_compute_slice_grid
from facedet_tpu.ops.tiler import gather_tiles as jax_gather_tiles
from facedet_tpu.ops.tiler import pad_grid_offsets as jax_pad_grid_offsets
from facedet_tpu_torch.ops import tiler
from facedet_tpu_torch.ops.kernels import tile_gather as tg

DTYPES = {
    "uint8": (np.uint8, torch.uint8),
    "float32": (np.float32, torch.float32),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
}


def _image(shape, dtype_name, seed=0):
    np_dt, t_dt = DTYPES[dtype_name]
    arr = np.random.default_rng(seed).integers(0, 256, shape).astype(np_dt)
    t = torch.from_numpy(arr.astype(np.float32)).to(t_dt)
    return arr, t


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else np.asarray(a)


def test_hwc_matches_xla_and_pallas_interpret():
    """tests/test_pallas_gather.py:8-17's case."""
    img = np.arange(40 * 56 * 3, dtype=np.float32).reshape(40, 56, 3)
    offs = np.array([[0, 0], [8, 16], [24, 40]], np.int32)
    want = np.asarray(jax_gather_tiles(jnp.asarray(img), jnp.asarray(offs), 16, 16))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(gather_tiles_pallas(jnp.asarray(img), jnp.asarray(offs), 16, 16))
    got = tiler.gather_tiles(torch.from_numpy(img), torch.from_numpy(offs), 16, 16).numpy()
    assert got.shape == (3, 16, 16, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_chw_matches_static_pallas_interpret():
    """tests/test_pallas_gather.py:20-38's case."""
    offs = ((0, 0), (0, 128), (8, 256))
    img = np.random.default_rng(0).integers(0, 255, (3, 72, 512), np.uint8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(gather_tiles_pallas_static(jnp.asarray(img), offs, 64, 128))
    got = tg.gather_tiles_chw(torch.from_numpy(img), offs, 64, 128).numpy()
    assert got.shape == (3, 3, 64, 128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_production_grid_both_layouts(dtype):
    """The 1024x1536 / 640 / 0.2 grid of tests/test_pallas_gather.py:56-65,
    padded to its tile bucket of 6, in each dtype the kernels take."""
    grid = tiler.compute_slice_grid(1024, 1536, 640, 640, 0.2, 0.2)
    offsets, _ = tiler.pad_grid_offsets(grid, tiler.bucket_tile_count(grid.num_tiles))
    jgrid = jax_compute_slice_grid(1024, 1536, 640, 640, 0.2, 0.2)
    np.testing.assert_array_equal(offsets, jax_pad_grid_offsets(jgrid, 6)[0])
    arr, img = _image((1024, 1536, 3), dtype)
    want = _jnp(jax_gather_tiles(jnp.asarray(arr), jnp.asarray(offsets), 640, 640))
    got = tiler.gather_tiles(img, torch.from_numpy(offsets), 640, 640)
    assert got.dtype == img.dtype and got.shape == (6, 640, 640, 3)
    np.testing.assert_array_equal(_np(got), want)
    chw = tg.gather_tiles_chw(img.permute(2, 0, 1).contiguous(), torch.from_numpy(offsets), 640, 640)
    np.testing.assert_array_equal(_np(chw), want.transpose(0, 3, 1, 2))


def test_production_grid_chw_matches_static_pallas_interpret():
    grid = tiler.compute_slice_grid(1024, 1536, 640, 640, 0.2, 0.2)
    img = np.random.default_rng(1).integers(0, 255, (3, 1024, 1536), np.uint8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(gather_tiles_pallas_static(jnp.asarray(img), grid.offsets, 640, 640))
    got = tg.gather_tiles_chw(torch.from_numpy(img), grid.offsets, 640, 640).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_out_of_range_offsets_clamp_like_dynamic_slice(dtype):
    """Offsets past either edge map to a start as ``lax.dynamic_slice`` maps
    them: a negative one counts from the end, then the window is clamped."""
    arr, img = _image((40, 56, 3), dtype, seed=2)
    offs = np.array([[-5, 2000], [30, -3], [-30, -50], [-100, 9], [1000, 1000], [3, 7]], np.int32)
    want = _jnp(jax_gather_tiles(jnp.asarray(arr), jnp.asarray(offs), 16, 24))
    got = tiler.gather_tiles(img, torch.from_numpy(offs), 16, 24)
    np.testing.assert_array_equal(_np(got), want)
    chw = tg.gather_tiles_chw(img.permute(2, 0, 1).contiguous(), torch.from_numpy(offs), 16, 24)
    np.testing.assert_array_equal(_np(chw), want.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("batch", [1, 3])
def test_batched_chw_matches_vmap_of_jax_gather(dtype, batch):
    """The batch pipeline maps the gather over the images of a chunk
    (facedet_tpu/engine/predict.py:357-361) and flattens to [B*T, ...],
    image-major. Offsets include unaligned and out-of-range ones."""
    np_dt, t_dt = DTYPES[dtype]
    arr = np.random.default_rng(5).integers(0, 256, (batch, 72, 96, 3)).astype(np_dt)
    offs = np.array([[0, 0], [8, 16], [51, 77], [-5, 2000], [1000, -3]], np.int32)
    want = jax.vmap(lambda p: jax_gather_tiles(p, jnp.asarray(offs), 16, 24))(jnp.asarray(arr))
    want = _jnp(want).reshape(batch * 5, 16, 24, 3).transpose(0, 3, 1, 2)
    chw = torch.from_numpy(arr.astype(np.float32)).to(t_dt).permute(0, 3, 1, 2).contiguous()
    got = tg.gather_tiles_chw(chw, torch.from_numpy(offs), 16, 24)
    assert got.dtype == t_dt and got.shape == (batch * 5, 3, 16, 24)
    np.testing.assert_array_equal(_np(got), want)
    # image b's tiles are rows [b*T, (b+1)*T), equal to the single-image call
    for b in range(batch):
        single = tg.gather_tiles_chw(chw[b], torch.from_numpy(offs), 16, 24)
        assert torch.equal(got[b * 5 : (b + 1) * 5], single)


def test_batched_chw_production_grid_and_static_offsets():
    grid = tiler.compute_slice_grid(1024, 1536, 640, 640, 0.2, 0.2)
    img = torch.from_numpy(np.random.default_rng(6).integers(0, 255, (2, 3, 1024, 1536), np.uint8))
    got = tg.gather_tiles_chw(img, grid.offsets, 640, 640)
    assert got.shape == (12, 3, 640, 640)
    for b in range(2):
        for t, (y, x) in enumerate(grid.offsets):
            assert torch.equal(got[b * 6 + t], img[b, :, y : y + 640, x : x + 640])
    with pytest.raises(ValueError, match="outside"):
        tg.gather_tiles_chw(img, [(500, 0)], 640, 640)
    with pytest.raises(ValueError, match="rank 3 or 4"):
        tg.gather_tiles_chw(img[None], torch.zeros((1, 2), dtype=torch.int32), 640, 640)


def test_single_tile():
    arr, img = _image((33, 47, 3), "uint8", seed=3)
    offs = np.array([[5, 9]], np.int32)
    want = np.asarray(jax_gather_tiles(jnp.asarray(arr), jnp.asarray(offs), 20, 31))
    np.testing.assert_array_equal(tiler.gather_tiles(img, torch.from_numpy(offs), 20, 31).numpy(), want)


def test_static_chw_rejects_out_of_bounds_window_but_not_unaligned():
    img = torch.zeros((3, 128, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="outside"):
        tg.gather_tiles_chw(img, [(70, 0)], 64, 128)
    # the (8, 128) alignment rule of the TPU kernel is dropped
    assert tg.gather_tiles_chw(img, [(51, 77)], 64, 128).shape == (1, 3, 64, 128)


def test_wrappers_reject_what_the_kernels_do_not_take():
    offs = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        tg.gather_tiles_hwc(torch.zeros((8, 8, 3), dtype=torch.int64), offs, 4, 4)
    with pytest.raises(ValueError):
        tg.gather_tiles_hwc(torch.zeros((8, 8, 3)), offs.long(), 4, 4)
    with pytest.raises(ValueError):
        tg.gather_tiles_hwc(torch.zeros((8, 8, 3)), offs, 9, 4)
    with pytest.raises(ValueError):
        tg.gather_tiles_chw(torch.zeros((3, 8)), offs, 4, 4)


def test_no_plain_fallback_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version; on a
    device that has no kernel the wrapper raises and counts nothing."""
    before = dict(tg.LAUNCHES)
    img = torch.zeros((8, 8, 3), device="meta")
    offs = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tg.gather_tiles_hwc(img, offs, 4, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tg.gather_tiles_chw(img.permute(2, 0, 1), offs, 4, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tg.gather_tiles_chw(img.permute(2, 0, 1)[None], offs, 4, 4)
    assert tg.LAUNCHES == before and set(before) == {"gather_hwc", "gather_chw", "gather_chw_batched"}


def test_enhance_first_grid_offsets_and_windows():
    """The enhance-first pipeline detects on a 2048x3072 canvas: a 4x4 plan
    of 25 tiles of 512x768 whose x offsets are odd multiples of the element
    size (615, 1845), bucketed to 32 tiles. Each tile equals its slice."""
    sh, sw, ov = tiler.fixed_grid_slice_params(2048, 3072)
    grid = tiler.compute_slice_grid(2048, 3072, sh, sw, ov, ov)
    jgrid = jax_compute_slice_grid(2048, 3072, sh, sw, ov, ov)
    np.testing.assert_array_equal(grid.offsets, jgrid.offsets)
    assert (sh, sw) == (512, 768) and grid.num_tiles == 25
    assert sorted(set(grid.offsets[:, 0])) == [0, 410, 820, 1230, 1536]
    assert sorted(set(grid.offsets[:, 1])) == [0, 615, 1230, 1845, 2304]
    offsets, valid = tiler.pad_grid_offsets(grid, tiler.bucket_tile_count(grid.num_tiles))
    assert offsets.shape == (32, 2) and valid.sum() == 25
    img = torch.from_numpy(np.random.default_rng(8).integers(0, 255, (3, 2048, 3072), np.uint8))
    got = tg.gather_tiles_chw(img, torch.from_numpy(offsets), sh, sw)
    assert got.shape == (32, 3, 512, 768)
    for t, (y, x) in enumerate(offsets):
        assert torch.equal(got[t], img[:, y : y + sh, x : x + sw])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chw_windows_that_are_not_square_match_dynamic_slice(dtype):
    """The enhancer gathers halo windows of any shape from a padded CHW
    image (facedet_tpu/engine/enhancer.py:125-130 is a vmap of
    ``lax.dynamic_slice``): static offsets, odd sizes."""
    np_dt, t_dt = DTYPES[dtype]
    arr = np.random.default_rng(9).integers(0, 256, (3, 53, 71)).astype(np_dt)
    offs = [(0, 0), (0, 24), (16, 0), (16, 24), (30, 38)]
    want = np.stack([
        _jnp(jax.lax.dynamic_slice(jnp.asarray(arr), (0, y, x), (3, 23, 33))) for y, x in offs
    ])
    img = torch.from_numpy(arr.astype(np.float32)).to(t_dt)
    got = tg.gather_tiles_chw(img, offs, 23, 33)
    assert got.shape == (5, 3, 23, 33) and got.dtype == t_dt
    np.testing.assert_array_equal(_np(got), want)
