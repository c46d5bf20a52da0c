"""Overlapping-tile slicer — SAHI ``slice_image`` for the port.

Counterpart of facedet_tpu/ops/tiler.py. The grid functions are host code,
copied (the JAX module imports jax). ``gather_tiles`` moves the pixels with
the HWC CUDA kernel of ops/kernels/tile_gather.py for a CUDA image, and with
its plain version for a CPU image.

Grid semantics match ``sahi.slicing.get_slice_bboxes``: stride = S -
overlap*S, edge tiles are shifted inward so every tile is exactly S×S, and
images smaller than S are padded.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from facedet_tpu_torch.ops.kernels.tile_gather import gather_tiles_hwc

__all__ = [
    "TileGrid",
    "compute_slice_grid",
    "adaptive_slice_size",
    "half_image_slice_size",
    "fixed_grid_slice_params",
    "bucket_tile_count",
    "pad_grid_offsets",
    "bucket_image_dim",
    "pad_image",
    "gather_tiles",
]


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static description of a slicing plan for one image shape."""

    offsets: np.ndarray  # [T, 2] int32 (y, x) top-left corners, exact-S tiles
    slice_h: int
    slice_w: int
    image_h: int
    image_w: int
    padded_h: int  # shape the image must be padded to before gathering
    padded_w: int

    @property
    def num_tiles(self) -> int:
        return int(self.offsets.shape[0])


def _axis_starts(size: int, slice_size: int, step: int) -> list[int]:
    starts = []
    pos = 0
    while pos + slice_size < size:
        starts.append(pos)
        pos += step
    starts.append(max(0, size - slice_size))
    return sorted(set(starts))


def compute_slice_grid(
    image_h: int,
    image_w: int,
    slice_h: int,
    slice_w: int,
    overlap_h: float = 0.2,
    overlap_w: float = 0.2,
) -> TileGrid:
    """SAHI-parity overlapping window grid (host, static)."""
    if slice_h <= 0 or slice_w <= 0:
        raise ValueError("slice size must be positive")
    ys = _axis_starts(image_h, slice_h, max(slice_h - int(overlap_h * slice_h), 1))
    xs = _axis_starts(image_w, slice_w, max(slice_w - int(overlap_w * slice_w), 1))
    offsets = np.array([(y, x) for y in ys for x in xs], dtype=np.int32).reshape(-1, 2)
    return TileGrid(
        offsets=offsets,
        slice_h=slice_h,
        slice_w=slice_w,
        image_h=image_h,
        image_w=image_w,
        padded_h=max(image_h, slice_h),
        padded_w=max(image_w, slice_w),
    )


def adaptive_slice_size(image_h: int, image_w: int) -> int:
    """Resolution-bucketed slice size."""
    max_dim = max(image_h, image_w)
    if max_dim > 2500:
        return 512
    if max_dim > 1500:
        return 416
    return 320


def half_image_slice_size(image_h: int, image_w: int, base: int = 512) -> tuple[int, int]:
    """Half-image slices for small inputs."""
    sh = image_h // 2 if image_h < int(1.5 * base) else base
    sw = image_w // 2 if image_w < int(1.5 * base) else base
    return max(sh, 64), max(sw, 64)


def fixed_grid_slice_params(image_h: int, image_w: int, round_to: int = 64) -> tuple[int, int, float]:
    """3x3 / 4x4 grid with dims rounded up to x64, overlap 0.2."""
    n = 3 if max(image_h, image_w) < 3000 else 4
    sh = math.ceil(image_h / n / round_to) * round_to
    sw = math.ceil(image_w / n / round_to) * round_to
    return sh, sw, 0.2


def bucket_tile_count(num_tiles: int) -> int:
    """Round tile counts up to coarse buckets, so tile batches of a
    variable-resolution stream take few distinct shapes."""
    for b in (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128):
        if num_tiles <= b:
            return b
    return int(2 ** math.ceil(math.log2(num_tiles)))


def pad_grid_offsets(grid: TileGrid, target_tiles: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad the offset list to ``target_tiles`` rows (repeating offset 0) and
    return (offsets [T,2], tile_valid [T] bool)."""
    t = grid.num_tiles
    if target_tiles < t:
        raise ValueError(f"target_tiles {target_tiles} < actual tiles {t}")
    offsets = np.zeros((target_tiles, 2), np.int32)
    offsets[:t] = grid.offsets
    valid = np.zeros((target_tiles,), bool)
    valid[:t] = True
    return offsets, valid


def bucket_image_dim(x: int, multiple: int = 256) -> int:
    """Round an image dimension up to a coarse bucket."""
    return max(multiple, -(-x // multiple) * multiple)


def pad_image(image: torch.Tensor, padded_h: int, padded_w: int) -> torch.Tensor:
    """Zero-pad an HWC image at the bottom and right so every tile lies in
    bounds (the image itself where it already has that size)."""
    h, w = image.shape[0], image.shape[1]
    if h == padded_h and w == padded_w:
        return image
    return torch.nn.functional.pad(image, (0, 0, 0, padded_w - w, 0, padded_h - h))


def gather_tiles(image: torch.Tensor, offsets: torch.Tensor, slice_h: int, slice_w: int) -> torch.Tensor:
    """[H,W,C] + int32 [T,2] offsets (y, x) -> [T,slice_h,slice_w,C] tile
    batch. Offsets map to starts as ``lax.dynamic_slice`` maps them: a
    negative one counts from the end of its axis, then every window is
    clamped inside the image."""
    return gather_tiles_hwc(image, offsets, slice_h, slice_w)
