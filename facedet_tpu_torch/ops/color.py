"""Planar YUV 4:2:0 colour ops: the ``yuv420`` ingest format.

Counterpart of facedet_tpu/ops/color.py. JPEG sources are stored as
4:2:0-subsampled YCbCr, so uploading planar YUV420 (1.5 bytes a pixel) and
doing the chroma upsample and the colour conversion on the device halves the
host-to-device bytes against the RGB canvas, with no loss relative to the
decoded JPEG.

Conventions: JFIF full-range BT.601, the matrix libjpeg applies. Chroma is
the 2x2 box mean on the encode side and bilinear (half-pixel centres, edge
clamp) on the decode side.

The host functions (``rgb_to_yuv420``, ``yuv420_to_rgb_np``,
``yuv420_bytes``) are numpy, copied unchanged from the JAX module and
bit-identical to it. ``yuv420_to_rgb_f32`` runs on tensors, with any number
of leading batch axes.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "rgb_to_yuv420",
    "yuv420_to_rgb_np",
    "yuv420_to_rgb_f32",
    "yuv420_to_rgb_chw",
    "yuv420_bytes",
]

# JFIF full-range BT.601 (libjpeg jccolor.c constants).
_FWD = np.array(
    [
        [0.299, 0.587, 0.114],          # Y
        [-0.168735892, -0.331264108, 0.5],  # Cb (+128)
        [0.5, -0.418687589, -0.081312411],  # Cr (+128)
    ],
    np.float32,
)
_INV = np.array(
    [
        [1.0, 0.0, 1.402],              # R from (Y, Cb-128, Cr-128)
        [1.0, -0.344136286, -0.714136286],  # G
        [1.0, 1.772, 0.0],              # B
    ],
    np.float32,
)


def rgb_to_yuv420(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 RGB [H,W,3] -> (Y uint8 [H,W], UV uint8 [ceil(H/2),ceil(W/2),2]).

    Odd dimensions are edge-replicated to even before the 2x2 chroma mean (the
    JPEG convention). Host-side numpy.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    f = img.astype(np.float32)
    y = f @ _FWD[0]
    cb = f @ _FWD[1] + 128.0
    cr = f @ _FWD[2] + 128.0
    if h % 2 or w % 2:
        pad_h, pad_w = h % 2, w % 2
        cb = np.pad(cb, ((0, pad_h), (0, pad_w)), mode="edge")
        cr = np.pad(cr, ((0, pad_h), (0, pad_w)), mode="edge")
    hh, ww = cb.shape[0] // 2, cb.shape[1] // 2
    cb = cb.reshape(hh, 2, ww, 2).mean(axis=(1, 3))
    cr = cr.reshape(hh, 2, ww, 2).mean(axis=(1, 3))
    y8 = np.clip(np.rint(y), 0, 255).astype(np.uint8)
    uv8 = np.clip(np.rint(np.stack([cb, cr], axis=-1)), 0, 255).astype(np.uint8)
    return y8, uv8


def _up2x_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact 2x linear upsample along one axis (half-pixel centres, edge
    clamp): out[2i] = .25*x[i-1] + .75*x[i], out[2i+1] = .75*x[i] +
    .25*x[i+1], written as shifted adds."""
    x = x.movedim(axis, 0)
    xm = torch.cat([x[:1], x[:-1]], dim=0)
    xp = torch.cat([x[1:], x[-1:]], dim=0)
    even = 0.75 * x + 0.25 * xm
    odd = 0.75 * x + 0.25 * xp
    out = torch.stack([even, odd], dim=1).reshape((2 * x.shape[0],) + x.shape[1:])
    return out.movedim(0, axis)


def _upsample_chroma(uv: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., h/2, w/2] chroma planes -> [..., h, w] by bilinear 2x upsample.
    Other ratios take ``jax.image.resize``'s linear weights (ops/image.py)."""
    if h == 2 * uv.shape[-2] and w == 2 * uv.shape[-1]:
        return _up2x_axis(_up2x_axis(uv, -2), -1)
    from facedet_tpu_torch.ops.image import resize_chw

    return resize_chw(uv, h, w)


def yuv420_to_rgb_chw(y: torch.Tensor, uv: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """(Y [...,H,W], UV [...,H/2,W/2,2], uint8 or float) -> RGB [...,3,H,W]
    in [0, 1]: the channel-first canvas the detector's convs and the CHW tile
    gather take. The colour conversion is one [3,3] @ [3, H*W] product per
    image, so the result is channel-first without a transpose pass.

    ``out_dtype=torch.bfloat16`` does the upsample and the product in
    bfloat16 (half the bytes moved by the canvas stages); on the [0, 255]
    scale that costs at most about half a pixel level, the rounding a uint8
    decode applies anyway. float32 keeps exact float32 arithmetic."""
    h, w = y.shape[-2], y.shape[-1]
    yf = y.to(out_dtype)
    uvf = _upsample_chroma(uv.to(out_dtype).movedim(-1, -3), h, w) - 128.0
    ycc = torch.cat([yf.unsqueeze(-3), uvf], dim=-3)  # [..., 3, H, W]
    inv = torch.from_numpy(_INV).to(device=y.device, dtype=out_dtype)
    rgb = torch.matmul(inv, ycc.flatten(-2)).reshape(ycc.shape)
    return (rgb / 255.0).clamp(0.0, 1.0)


def yuv420_to_rgb_f32(y: torch.Tensor, uv: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """(Y [...,H,W], UV [...,H/2,W/2,2]) -> RGB [...,H,W,3] in [0, 1], the
    layout the JAX function returns (a view of ``yuv420_to_rgb_chw``)."""
    return yuv420_to_rgb_chw(y, uv, out_dtype).movedim(-3, -1)


def yuv420_to_rgb_np(y: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Host-side reconstruction (for visualization of YUV-ingested frames)."""
    h, w = y.shape[:2]
    uvf = uv.astype(np.float32)
    # nearest-doubling then crop keeps this dependency-free; visualization only
    up = np.repeat(np.repeat(uvf, 2, axis=0), 2, axis=1)[:h, :w] - 128.0
    ycc = np.stack([y.astype(np.float32), up[..., 0], up[..., 1]], axis=-1)
    rgb = ycc @ _INV.T
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def yuv420_bytes(h: int, w: int) -> int:
    """Host-to-device bytes of one YUV420 image at (even-bucketed) h x w."""
    return h * w + 2 * ((h + 1) // 2) * ((w + 1) // 2)
