"""Plain float32 decode of the benchmark's inputs into the detector's canvas:
quantized 4:2:0 DCT planes (JPEG's representation) -> RGB in [0, 1], and
uint8 RGB -> [0, 1]. Written from the JPEG and JFIF definitions:
dequantise, 8x8 inverse DCT (orthonormal, libjpeg's scaling), level shift
+128, clip to [0, 255]; chroma upsampled 2x with weights 3/4 and 1/4
(half-pixel centres, edge samples repeated); full-range BT.601 to RGB; /255,
clipped to [0, 1]. Nothing of the program is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.inputs import YCC_TO_RGB, dct_matrix


def _idct_plane(dc: np.ndarray, ac: np.ndarray, q: np.ndarray, device) -> torch.Tensor:
    coef = torch.from_numpy(ac.astype(np.float32)).to(device)
    coef[..., 0] = torch.from_numpy(dc.astype(np.float32)).to(device)
    hb, wb = coef.shape[:2]
    coef = (coef * torch.from_numpy(q).to(device)).reshape(hb, wb, 8, 8)
    c = torch.from_numpy(dct_matrix()).to(device)
    blocks = torch.einsum("ji,byjk,kl->byil", c, coef, c) + 128.0
    return blocks.clamp(0.0, 255.0).permute(0, 2, 1, 3).reshape(hb * 8, wb * 8)


def _up2(x: torch.Tensor, axis: int) -> torch.Tensor:
    x = x.movedim(axis, 0)
    prev = torch.cat([x[:1], x[:-1]])
    nxt = torch.cat([x[1:], x[-1:]])
    out = torch.stack([0.75 * x + 0.25 * prev, 0.75 * x + 0.25 * nxt], 1).reshape(2 * x.shape[0], *x.shape[1:])
    return out.movedim(0, axis)


def dct_canvas(planes: dict, canvas_hw, device) -> torch.Tensor:
    """DCT planes (the dict of ``inputs.encode_dct420``) -> [3, H, W] float32
    canvas: the image at the top left, black beyond it."""
    y = _idct_plane(planes["y_dc"], planes["y_ac"], planes["qy"], device)
    uv = torch.stack([_idct_plane(planes["uv_dc"][..., i], planes["uv_ac"][..., i, :], planes["qc"], device)
                      for i in range(2)])
    uv = _up2(_up2(uv, 1), 2) - 128.0
    ycc = torch.cat([y[None], uv])
    rgb = torch.einsum("ij,jhw->ihw", torch.from_numpy(YCC_TO_RGB).to(device), ycc)
    rgb = (rgb / 255.0).clamp(0.0, 1.0)
    return _pad(rgb, canvas_hw)


def rgb_canvas(image: np.ndarray, canvas_hw, device) -> torch.Tensor:
    """uint8 RGB [H, W, 3] -> [3, Hc, Wc] float32 canvas in [0, 1]."""
    rgb = torch.from_numpy(np.ascontiguousarray(image)).to(device).permute(2, 0, 1).float() / 255.0
    return _pad(rgb, canvas_hw)


def _pad(chw: torch.Tensor, canvas_hw) -> torch.Tensor:
    out = torch.zeros((3, *canvas_hw), dtype=torch.float32, device=chw.device)
    out[:, :chw.shape[1], :chw.shape[2]] = chw
    return out
