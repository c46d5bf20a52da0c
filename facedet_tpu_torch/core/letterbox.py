"""Aspect-preserving resize + pad (letterbox) and its inverse box mapping.

Counterpart of facedet_tpu/core/letterbox.py. The geometry is computed on the
host; the resize uses ``jax.image.resize``'s antialiased bilinear weights
(ops/image.py), not ``F.interpolate``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from facedet_tpu_torch.ops.image import resize_chw

__all__ = [
    "LetterboxSpec",
    "compute_letterbox",
    "apply_letterbox",
    "unletterbox_boxes",
    "unletterbox_kpts",
]


@dataclasses.dataclass(frozen=True)
class LetterboxSpec:
    src_h: int
    src_w: int
    dst: int  # square target
    new_h: int
    new_w: int
    pad_top: int
    pad_left: int
    scale: float


def compute_letterbox(src_h: int, src_w: int, dst: int) -> LetterboxSpec:
    scale = min(dst / src_h, dst / src_w)
    new_h = min(dst, max(1, round(src_h * scale)))
    new_w = min(dst, max(1, round(src_w * scale)))
    pad_top = (dst - new_h) // 2
    pad_left = (dst - new_w) // 2
    return LetterboxSpec(src_h, src_w, dst, new_h, new_w, pad_top, pad_left, scale)


def apply_letterbox(image: torch.Tensor, spec: LetterboxSpec, pad_value: float = 114 / 255) -> torch.Tensor:
    """image [H,W,3] float in [0,1] -> [dst,dst,3]."""
    resized = resize_chw(image.permute(2, 0, 1), spec.new_h, spec.new_w)
    padded = F.pad(
        resized,
        (
            spec.pad_left,
            spec.dst - spec.new_w - spec.pad_left,
            spec.pad_top,
            spec.dst - spec.new_h - spec.pad_top,
        ),
        value=pad_value,
    )
    return padded.permute(1, 2, 0)


def unletterbox_boxes(boxes: torch.Tensor, spec: LetterboxSpec) -> torch.Tensor:
    """Map xyxy boxes from letterboxed coords back to source-image coords."""
    offset = torch.tensor(
        [spec.pad_left, spec.pad_top, spec.pad_left, spec.pad_top],
        dtype=boxes.dtype,
        device=boxes.device,
    )
    return (boxes - offset) / spec.scale


def unletterbox_kpts(kpts: torch.Tensor, spec: LetterboxSpec) -> torch.Tensor:
    """kpts [..., 3] (x, y, v) letterboxed -> source coords."""
    x = (kpts[..., 0] - spec.pad_left) / spec.scale
    y = (kpts[..., 1] - spec.pad_top) / spec.scale
    return torch.stack([x, y, kpts[..., 2]], dim=-1)
