"""Separable linear resampling with ``jax.image``'s semantics.

``jax.image.scale_and_translate(method="linear")`` and
``jax.image.resize(..., "bilinear")`` apply, per spatial axis, a weight
matrix built by ``jax/_src/image/scale.py:compute_weight_mat``: a triangle
kernel widened by ``1/scale`` when downscaling (antialias), columns
normalised by their sum, and output samples that fall outside the input
zeroed. ``F.interpolate`` computes something else. Here the same matrices are
built and applied as two matmuls over an image in CHW layout.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["compute_weight_mat", "scale_and_translate_chw", "resize_chw"]


def compute_weight_mat(in_size: int, out_size: int, scale, translation=0.0, device=None) -> torch.Tensor:
    """[in_size, out_size] float32 weights. ``scale`` is a Python float (as in
    ``jax.image.resize``, where ``1/scale`` is taken in double precision) or a
    float32 scalar (as in ``scale_and_translate`` with a traced scale)."""
    f32 = torch.float32
    if isinstance(scale, (np.floating, torch.Tensor)):
        scale = torch.as_tensor(scale, dtype=f32, device=device)
    inv_scale = 1.0 / scale
    if isinstance(inv_scale, torch.Tensor):
        kernel_scale = torch.clamp(inv_scale, min=1.0)
    else:
        kernel_scale = float(np.float32(max(inv_scale, 1.0)))
    sample_f = (
        (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale
        - translation * inv_scale
        - 0.5
    )
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs() / kernel_scale
    weights = (1.0 - x.abs()).clamp(min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def scale_and_translate_chw(image: torch.Tensor, out_h: int, out_w: int, scale) -> torch.Tensor:
    """``jax.image.scale_and_translate(image_hwc, (out_h, out_w, C), (0, 1),
    [scale, scale], [0, 0], method="linear")`` for an image in CHW layout
    (any leading batch axes; one scale for the batch). The weights are cast
    to the image dtype first, as in JAX."""
    h, w = image.shape[-2:]
    wh = compute_weight_mat(h, out_h, scale, device=image.device).to(image.dtype)
    ww = compute_weight_mat(w, out_w, scale, device=image.device).to(image.dtype)
    return torch.matmul(torch.matmul(wh.t(), image), ww)


def resize_chw(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(image_hwc, (out_h, out_w, C), "bilinear")`` for an
    image in CHW layout (any leading axes): axes whose size does not change
    are left alone."""
    h, w = image.shape[-2:]
    out = image
    if out_h != h:
        wh = compute_weight_mat(h, out_h, out_h / h, device=image.device).to(image.dtype)
        out = torch.matmul(wh.t(), out)
    if out_w != w:
        ww = compute_weight_mat(w, out_w, out_w / w, device=image.device).to(image.dtype)
        out = torch.matmul(out, ww)
    return out
