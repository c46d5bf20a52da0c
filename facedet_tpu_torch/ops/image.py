"""Separable resampling with ``jax.image``'s semantics.

``jax.image.scale_and_translate(method="linear")`` and
``jax.image.resize(..., "bilinear" | "lanczos3")`` apply, per spatial axis, a
weight matrix built by ``jax/_src/image/scale.py:compute_weight_mat``: a
triangle or a Lanczos kernel of radius 3, widened by ``1/scale`` when
downscaling (antialias), columns normalised by their sum, and output samples
that fall outside the input zeroed. ``F.interpolate`` computes something else
and has no Lanczos kernel. Here the same matrices are built and applied as
two matmuls over an image in CHW layout.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["compute_weight_mat", "scale_and_translate_chw", "resize_chw", "resize_nd", "reflect_pad"]


def _triangle_kernel(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x).clamp(min=0.0)


def _lanczos3_kernel(x: torch.Tensor) -> torch.Tensor:
    radius = 3.0
    y = radius * torch.sin(np.pi * x) * torch.sin(np.pi * x / radius)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, np.pi**2 * x**2, torch.ones_like(x)), torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


def _keys_cubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 (``jax.image``'s
    "cubic"; ``F.interpolate(mode="bicubic")`` uses a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {
    "linear": _triangle_kernel,
    "bilinear": _triangle_kernel,
    "lanczos3": _lanczos3_kernel,
    "cubic": _keys_cubic_kernel,
}


def compute_weight_mat(in_size: int, out_size: int, scale, translation=0.0, device=None,
                       kernel: str = "linear") -> torch.Tensor:
    """[in_size, out_size] float32 weights. ``scale`` is a Python float (as in
    ``jax.image.resize``, where ``1/scale`` is taken in double precision) or a
    float32 tensor (as in ``scale_and_translate`` with a traced scale). A
    ``scale`` and ``translation`` of shape [N] (one per box, as under
    ``jax.vmap``) give [N, in_size, out_size]."""
    f32 = torch.float32
    if isinstance(scale, (np.floating, torch.Tensor)):
        scale = torch.as_tensor(scale, dtype=f32, device=device)
    inv_scale = 1.0 / scale
    if isinstance(inv_scale, torch.Tensor):
        kernel_scale = torch.clamp(inv_scale, min=1.0)
        if inv_scale.dim():  # per-box: broadcast over [N, in, out]
            inv_scale = inv_scale[:, None]
            kernel_scale = kernel_scale[:, None, None]
            translation = torch.as_tensor(translation, dtype=f32, device=device).reshape(-1, 1)
    else:
        kernel_scale = float(np.float32(max(inv_scale, 1.0)))
    sample_f = (
        (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale
        - translation * inv_scale
        - 0.5
    )
    x = (sample_f[..., None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs() / kernel_scale
    weights = _KERNELS[kernel](x)
    total = weights.sum(dim=-2, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None, :], weights, torch.zeros_like(weights))


def scale_and_translate_chw(image: torch.Tensor, out_h: int, out_w: int, scale) -> torch.Tensor:
    """``jax.image.scale_and_translate(image_hwc, (out_h, out_w, C), (0, 1),
    [scale, scale], [0, 0], method="linear")`` for an image in CHW layout
    (any leading batch axes; one scale for the batch). The weights are cast
    to the image dtype first, as in JAX."""
    h, w = image.shape[-2:]
    wh = compute_weight_mat(h, out_h, scale, device=image.device).to(image.dtype)
    ww = compute_weight_mat(w, out_w, scale, device=image.device).to(image.dtype)
    return torch.matmul(torch.matmul(wh.t(), image), ww)


def resize_nd(x: torch.Tensor, sizes, method: str) -> torch.Tensor:
    """``jax.image.resize(x, sizes, method)`` for a tensor of any rank,
    ``method`` "nearest", "linear" (or "bilinear"), "cubic" or "lanczos3";
    axes whose size does not change are left alone. "nearest" takes ``floor((i + 0.5) * in / out)``
    (torch's ``nearest-exact``); the others apply ``compute_weight_mat``
    along each axis, antialiased where it shrinks."""
    if len(sizes) != x.dim():
        raise ValueError(f"resize to {tuple(sizes)} of a tensor of shape {tuple(x.shape)}")
    for axis, (n_in, n_out) in enumerate(zip(x.shape, sizes)):
        if n_in == n_out:
            continue
        if method == "nearest":
            pos = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * n_in / n_out  # float32, in JAX's order
            x = x.index_select(axis, pos.floor().to(torch.long))
        else:
            w = compute_weight_mat(n_in, n_out, n_out / n_in, device=x.device, kernel=method).to(x.dtype)
            x = torch.movedim(torch.matmul(torch.movedim(x, axis, -1), w), -1, axis)
    return x


def resize_chw(image: torch.Tensor, out_h: int, out_w: int, method: str = "bilinear") -> torch.Tensor:
    """``jax.image.resize(image_hwc, (out_h, out_w, C), method)`` for an image
    in CHW layout (any leading axes), ``method`` "bilinear" or "lanczos3",
    antialiased where it shrinks: axes whose size does not change are left
    alone."""
    return resize_nd(image, (*image.shape[:-2], out_h, out_w), method)


def _reflect_index(n: int, before: int, after: int, device=None) -> torch.Tensor:
    """Source index of every position of an axis of length ``n`` padded by
    ``before`` and ``after`` in ``numpy.pad``'s "reflect" mode: mirrored
    about the edge samples without repeating them, and reflected again and
    again where the pad is longer than the axis."""
    pos = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(pos)
    period = 2 * (n - 1)
    m = pos % period  # torch's remainder is non-negative for a positive period
    return torch.where(m < n, m, period - m)


def reflect_pad(x: torch.Tensor, pads: dict[int, tuple[int, int]]) -> torch.Tensor:
    """``jnp.pad(x, ..., mode="reflect")`` on the axes of ``pads``
    ({axis: (before, after)}), as an index map. ``F.pad(mode="reflect")``
    raises where a pad reaches the axis length; this does not."""
    for axis, (before, after) in pads.items():
        if before or after:
            x = x.index_select(axis, _reflect_index(x.shape[axis], before, after, x.device))
    return x
