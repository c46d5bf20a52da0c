"""SAHI tile gather: the CUDA kernels of ``csrc/tile_gather.cu`` and their
plain PyTorch versions.

Counterpart of facedet_tpu/ops/pallas/tile_gather.py. Two layouts:

  * ``gather_tiles_hwc``: image [H,W,C] + offsets [T,2] (y, x) ->
    tiles [T,S_h,S_w,C] (replaces ``gather_tiles_pallas``);
  * ``gather_tiles_chw``: image [C,H,W] -> tiles [T,C,S_h,S_w] (replaces
    ``gather_tiles_pallas_static``). ``get_sliced_prediction`` uses this
    one: the detector's convs take NCHW. With a batch of same-size canvases
    [B,C,H,W] it returns [B*T,C,S_h,S_w], image-major, from one launch
    (replaces ``jax.vmap`` of the kernel in the batch pipeline).

Offsets follow ``lax.dynamic_slice``: a negative offset counts from the end
of its axis, and the start is then clamped to ``[0, dim - size]``. A CUDA
tensor launches the kernel (or raises); a CPU tensor takes the plain
version. There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

__all__ = [
    "LAUNCHES",
    "gather_tiles_hwc",
    "gather_tiles_chw",
    "gather_tiles_hwc_ref",
    "gather_tiles_chw_ref",
]

# Launch counts, one per kernel: a run reads them to show it went through the
# kernels. Only the CUDA branch of a wrapper increments them.
LAUNCHES = {"gather_hwc": 0, "gather_chw": 0, "gather_chw_batched": 0}

_DTYPES = (torch.uint8, torch.float32, torch.bfloat16)
_GRID_Y_MAX = _GRID_Z_MAX = 65535

Offsets = Union[torch.Tensor, Sequence[Sequence[int]], np.ndarray]


def _start(off: torch.Tensor, dim: int, size: int) -> list[int]:
    """``lax.dynamic_slice``'s start index: a negative offset counts from the
    end of the axis, then the window is clamped into ``[0, dim - size]``."""
    return torch.where(off < 0, off + dim, off).clamp(0, dim - size).tolist()


def _starts(offsets: torch.Tensor, h: int, w: int, slice_h: int, slice_w: int):
    return _start(offsets[:, 0], h, slice_h), _start(offsets[:, 1], w, slice_w)


def gather_tiles_hwc_ref(image, offsets, slice_h: int, slice_w: int) -> torch.Tensor:
    """Plain version of the HWC kernel: one slice per tile."""
    h, w = image.shape[0], image.shape[1]
    ys, xs = _starts(offsets, h, w, slice_h, slice_w)
    return torch.stack([image[y : y + slice_h, x : x + slice_w] for y, x in zip(ys, xs)])


def gather_tiles_chw_ref(image, offsets, slice_h: int, slice_w: int) -> torch.Tensor:
    """Plain version of the CHW kernel: one slice per tile. A batch
    [B,C,H,W] gives [B*T,C,S_h,S_w], image-major."""
    h, w = image.shape[-2], image.shape[-1]
    ys, xs = _starts(offsets, h, w, slice_h, slice_w)
    tiles = torch.stack([image[..., y : y + slice_h, x : x + slice_w] for y, x in zip(ys, xs)], dim=-4)
    return tiles.flatten(0, 1) if image.dim() == 4 else tiles


def _check(image: torch.Tensor, offsets: torch.Tensor, h: int, w: int, slice_h: int, slice_w: int,
           ranks=(3,)):
    if image.dim() not in ranks:
        raise ValueError(f"image must be rank {' or '.join(map(str, ranks))}, got shape {tuple(image.shape)}")
    if image.dtype not in _DTYPES:
        raise TypeError(f"image dtype {image.dtype} not in {_DTYPES}")
    if offsets.dim() != 2 or offsets.shape[1] != 2 or offsets.dtype != torch.int32:
        raise ValueError("offsets must be int32 [T, 2] (y, x)")
    if offsets.device != image.device:
        raise ValueError(f"offsets on {offsets.device}, image on {image.device}")
    if not (0 < slice_h <= h and 0 < slice_w <= w):
        raise ValueError(f"slice {slice_h}x{slice_w} does not fit image {h}x{w}")


def _launch(fn_name: str, image, offsets, out, counts, dims, slice_h, slice_w) -> None:
    from facedet_tpu_torch.ops.kernels import build

    if not image.is_contiguous() or not offsets.is_contiguous():
        raise ValueError("image and offsets must be contiguous")
    lib = build.load("tile_gather")
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn_name)(
            image.data_ptr(), offsets.data_ptr(), out.data_ptr(), *counts, *dims,
            slice_h, slice_w, image.element_size(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError_t {rc}")


def gather_tiles_hwc(image: torch.Tensor, offsets: torch.Tensor, slice_h: int, slice_w: int) -> torch.Tensor:
    """image [H,W,C] + int32 offsets [T,2] (y, x) -> tiles [T,slice_h,slice_w,C]."""
    h, w, c = image.shape if image.dim() == 3 else (0, 0, 0)
    _check(image, offsets, h, w, slice_h, slice_w)
    if image.device.type == "cpu":
        return gather_tiles_hwc_ref(image, offsets, slice_h, slice_w)
    if image.device.type != "cuda":
        raise ValueError(f"unsupported device {image.device}")
    t = offsets.shape[0]
    if t > _GRID_Y_MAX:
        raise ValueError(f"{t} tiles exceed the kernel's grid")
    out = torch.empty((t, slice_h, slice_w, c), dtype=image.dtype, device=image.device)
    _launch("facedet_tile_gather_hwc", image, offsets, out, (t,), (h, w, c), slice_h, slice_w)
    LAUNCHES["gather_hwc"] += 1
    return out


def gather_tiles_chw(image: torch.Tensor, offsets: Offsets, slice_h: int, slice_w: int) -> torch.Tensor:
    """image [C,H,W] + offsets [T,2] (y, x) -> tiles [T,C,slice_h,slice_w];
    a batch [B,C,H,W] shares the offsets and gives [B*T,C,slice_h,slice_w],
    image-major, from one launch.

    ``offsets`` is an int32 tensor on the image's device (mapped to starts
    as ``lax.dynamic_slice`` maps them) or a static sequence of (y, x), which must put
    every window inside the image (``ValueError`` otherwise)."""
    c, h, w = image.shape[-3:] if image.dim() in (3, 4) else (0, 0, 0)
    if not isinstance(offsets, torch.Tensor):
        offs = np.asarray(offsets, np.int64).reshape(-1, 2)
        bad = [
            (int(y), int(x)) for y, x in offs
            if not (0 <= y <= h - slice_h and 0 <= x <= w - slice_w)
        ]
        if bad:
            raise ValueError(
                f"static offsets {bad} put a {slice_h}x{slice_w} window outside the {h}x{w} image"
            )
        offsets = torch.as_tensor(offs.astype(np.int32), device=image.device)
    _check(image, offsets, h, w, slice_h, slice_w, ranks=(3, 4))
    if image.device.type == "cpu":
        return gather_tiles_chw_ref(image, offsets, slice_h, slice_w)
    if image.device.type != "cuda":
        raise ValueError(f"unsupported device {image.device}")
    t = offsets.shape[0]
    if t * c > _GRID_Y_MAX:
        raise ValueError(f"{t} tiles x {c} channels exceed the kernel's grid")
    if image.dim() == 3:
        out = torch.empty((t, c, slice_h, slice_w), dtype=image.dtype, device=image.device)
        _launch("facedet_tile_gather_chw", image, offsets, out, (t,), (c, h, w), slice_h, slice_w)
        LAUNCHES["gather_chw"] += 1
        return out
    b = image.shape[0]
    if b > _GRID_Z_MAX:
        raise ValueError(f"{b} images exceed the kernel's grid")
    out = torch.empty((b * t, c, slice_h, slice_w), dtype=image.dtype, device=image.device)
    _launch("facedet_tile_gather_chw_batched", image, offsets, out, (b, t), (c, h, w), slice_h, slice_w)
    LAUNCHES["gather_chw_batched"] += 1
    return out
