"""The tile-gather CUDA kernels (facedet_tpu_torch/csrc/tile_gather.cu)
against their plain PyTorch versions on the card. Bit-exact: a gather
copies values.

Marked ``cuda``: they skip where torch sees no card. This file imports
neither jax nor the JAX package, so it also runs on a machine that has only
the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_cuda.py
"""
import numpy as np
import pytest
import torch

from facedet_tpu_torch.ops.kernels import tile_gather as tg

DTYPES = {"uint8": torch.uint8, "float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernels_match_plain_versions_on_card(cuda, dtype):
    arr = np.random.default_rng(4).integers(0, 256, (1024, 1536, 3)).astype(np.float32)
    img = torch.from_numpy(arr).to(DTYPES[dtype]).to(cuda)
    offs = torch.tensor([[0, 0], [0, 512], [384, 896], [-5, 2000], [3, 7]], dtype=torch.int32, device=cuda)
    before = dict(tg.LAUNCHES)
    hwc = tg.gather_tiles_hwc(img, offs, 640, 640)
    chw_img = img.permute(2, 0, 1).contiguous()
    chw = tg.gather_tiles_chw(chw_img, offs, 640, 640)
    torch.cuda.synchronize()
    assert torch.equal(hwc, tg.gather_tiles_hwc_ref(img, offs, 640, 640))
    assert torch.equal(chw, tg.gather_tiles_chw_ref(chw_img, offs, 640, 640))
    assert tg.LAUNCHES["gather_hwc"] == before["gather_hwc"] + 1
    assert tg.LAUNCHES["gather_chw"] == before["gather_chw"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_batched_chw_kernel_matches_plain_version_on_card(cuda, dtype, batch):
    """One launch for the whole batch, counted once; production, unaligned
    and out-of-range offsets."""
    gen = torch.Generator(device=cuda).manual_seed(batch)
    img = torch.randint(0, 256, (batch, 3, 1024, 1536), generator=gen, device=cuda, dtype=torch.uint8).to(DTYPES[dtype])
    offs = torch.tensor(
        [[0, 0], [0, 512], [0, 896], [384, 0], [384, 512], [384, 896], [3, 5], [-5, 2000], [1000, -3]],
        dtype=torch.int32, device=cuda,
    )
    before = dict(tg.LAUNCHES)
    got = tg.gather_tiles_chw(img, offs, 640, 640)
    torch.cuda.synchronize()
    assert got.shape == (batch * 9, 3, 640, 640)
    assert torch.equal(got, tg.gather_tiles_chw_ref(img, offs, 640, 640))
    assert tg.LAUNCHES["gather_chw_batched"] == before["gather_chw_batched"] + 1
    assert tg.LAUNCHES["gather_chw"] == before["gather_chw"]
    with pytest.raises(ValueError, match="contiguous"):
        tg.gather_tiles_chw(img.transpose(2, 3), offs, 640, 640)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take_on_card(cuda):
    offs = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tg.gather_tiles_hwc(torch.zeros((8, 8, 3), device=cuda).transpose(0, 1), offs, 4, 4)
    with pytest.raises(ValueError, match="offsets on"):
        tg.gather_tiles_chw(torch.zeros((3, 8, 8), device=cuda), offs.cpu(), 4, 4)


# (canvas H, W, slice h, w, offsets): the shapes that take each path of the
# banded CHW kernel. Row bytes, strides and window starts that are multiples
# of 16 take the 16-byte path; an odd x offset with aligned tile rows takes
# the shifted-load path; an odd tile width leaves only 8-, 4-, 2- or 1-byte
# vectors, by dtype.
CHW_CASES = {
    "production": (1024, 1536, 640, 640, [[0, 0], [0, 512], [0, 896], [384, 0], [384, 512], [384, 896]]),
    "enhance_first_4x4": (2048, 3072, 512, 768, [[y, x] for y in (0, 410, 820, 1230, 1536) for x in (0, 615, 1230, 1845, 2304)]),
    "odd_start": (1024, 1536, 640, 640, [[3, 5], [51, 153], [383, 895], [1, 1], [7, 2]]),
    "odd_width": (333, 1531, 77, 637, [[0, 0], [5, 3], [256, 894], [100, 1]]),
    "odd_canvas_even_tile": (500, 1001, 96, 256, [[0, 0], [1, 1], [404, 745], [17, 300]]),
    "out_of_range": (1024, 1536, 640, 640, [[-5, 2000], [1000, -3], [-2000, 7], [0, 896]]),
    "short_last_band": (64, 256, 13, 128, [[0, 0], [51, 64], [20, 127]]),
    "one_tile": (1024, 1536, 640, 640, [[17, 33]]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CHW_CASES))
def test_banded_chw_kernel_paths_match_plain_version_on_card(cuda, case, dtype):
    h, w, sh, sw, offs = CHW_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    img = torch.randint(0, 256, (3, h, w), generator=gen, device=cuda, dtype=torch.uint8).to(DTYPES[dtype])
    o = torch.tensor(offs, dtype=torch.int32, device=cuda)
    got = tg.gather_tiles_chw(img, o, sh, sw)
    torch.cuda.synchronize()
    assert torch.equal(got, tg.gather_tiles_chw_ref(img, o, sh, sw))
    batch = torch.stack([img, img.flip(-1), img.flip(-2)])
    got = tg.gather_tiles_chw(batch, o, sh, sw)
    torch.cuda.synchronize()
    assert torch.equal(got, tg.gather_tiles_chw_ref(batch, o, sh, sw))


@pytest.mark.cuda
def test_chw_kernel_on_a_view_that_starts_off_alignment_on_card(cuda):
    """A contiguous tensor whose storage offset is odd: no address is
    aligned, and the byte path still copies the right values."""
    base = torch.randint(0, 256, (3 * 64 * 96 + 1,), device=cuda, dtype=torch.uint8)
    img = base[1:].view(3, 64, 96)
    o = torch.tensor([[0, 0], [10, 17], [32, 64]], dtype=torch.int32, device=cuda)
    got = tg.gather_tiles_chw(img, o, 32, 32)
    torch.cuda.synchronize()
    assert torch.equal(got, tg.gather_tiles_chw_ref(img, o, 32, 32))
