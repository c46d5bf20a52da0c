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
def test_kernels_refuse_what_they_do_not_take_on_card(cuda):
    offs = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tg.gather_tiles_hwc(torch.zeros((8, 8, 3), device=cuda).transpose(0, 1), offs, 4, 4)
    with pytest.raises(ValueError, match="offsets on"):
        tg.gather_tiles_chw(torch.zeros((3, 8, 8), device=cuda), offs.cpu(), 4, 4)
