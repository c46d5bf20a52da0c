"""The benchmark's inputs: seeded synthetic photos and their quantized DCT
planes, made by frozen copies of the program's recipes so that a later change
to the program cannot change what the benchmark feeds it.

``natural_background`` and ``faces_with_boxes`` copy the photo recipe of
``facedet_tpu_torch/utils/synth.py`` (``natural_background``,
``synthetic_faces_with_boxes``); ``rgb_to_yuv420`` and ``encode_dct420``
copy the host encoder of ``facedet_tpu_torch/ops/color.py`` and
``ops/jpeg_dct.py`` (JFIF BT.601, 2x2 chroma mean, IJG quality-90 tables,
orthonormal 8x8 DCT, AC clipped to int8). Everything is numpy and PIL.
"""
from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw

# JFIF full-range BT.601 (libjpeg jccolor.c constants)
RGB_TO_YCC = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168735892, -0.331264108, 0.5],
        [0.5, -0.418687589, -0.081312411],
    ],
    np.float32,
)
YCC_TO_RGB = np.array(
    [
        [1.0, 0.0, 1.402],
        [1.0, -0.344136286, -0.714136286],
        [1.0, 1.772, 0.0],
    ],
    np.float32,
)

# IJG standard base tables (Annex K of the JPEG spec)
_BASE_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.float32)
_BASE_CHROMA = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                         24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
                        + [99] * 32, np.float32)


def dct_matrix() -> np.ndarray:
    """Orthonormal type-II 8x8 DCT matrix, libjpeg's FDCT scaling."""
    k = np.arange(8)
    c = np.sqrt(2.0 / 8) * np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / 16)
    c[0] /= np.sqrt(2.0)
    return c.astype(np.float32)


def quality_tables(quality: int = 90) -> tuple[np.ndarray, np.ndarray]:
    q = max(1, min(100, int(quality)))
    scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
    tbl = lambda base: np.clip(np.floor((base * scale + 50.0) / 100.0), 1.0, 255.0).astype(np.float32)  # noqa: E731
    return tbl(_BASE_LUMA), tbl(_BASE_CHROMA)


def natural_background(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """[h, w, 3] uint8: smooth noise at three scales plus sensor noise, whose
    quantized DCT planes are mostly zeros, as a photograph's are."""
    base = np.zeros((h, w), np.float32)
    for octave in (8, 32, 128):
        up = np.kron(rng.standard_normal((octave, octave)).astype(np.float32),
                     np.ones((-(-h // octave), -(-w // octave)), np.float32))[:h, :w]
        base += up / octave**0.5
    base = (base - base.min()) / (base.max() - base.min())
    rgb = np.stack([base * 110 + 40, base * 100 + 45, base * 90 + 50], -1)
    rgb += rng.normal(0.0, 1.5, (h, w, 1)).astype(np.float32)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def faces_with_boxes(background: np.ndarray, n: int, size, rng: np.random.Generator):
    """``n`` cartoon faces of ``size`` px drawn on ``background``: (image,
    boxes [n, 4] xyxy spanning face and hair)."""
    h, w = background.shape[:2]
    img = Image.fromarray(background)
    d = ImageDraw.Draw(img)
    boxes = np.zeros((n, 4))
    for k in range(n):
        s = int(rng.integers(*size))
        cx = int(rng.integers(s, w - s))
        cy = int(rng.integers(s, h - s))
        boxes[k] = (cx - 0.45 * s, cy - 0.75 * s, cx + 0.45 * s, cy + 0.55 * s)
        skin = tuple(int(v) for v in rng.integers([180, 120, 90], [235, 170, 140]))
        d.ellipse([cx - 0.4 * s, cy - 0.55 * s, cx + 0.4 * s, cy + 0.55 * s], fill=skin)
        d.ellipse([cx - 0.45 * s, cy - 0.75 * s, cx + 0.45 * s, cy - 0.3 * s], fill=(40, 30, 20))
        for ex in (-0.17, 0.17):
            ox = cx + ex * s
            d.ellipse([ox - 0.07 * s, cy - 0.12 * s, ox + 0.07 * s, cy - 0.04 * s], fill=(255, 255, 255))
            d.ellipse([ox - 0.035 * s, cy - 0.11 * s, ox + 0.035 * s, cy - 0.05 * s], fill=(30, 20, 20))
        d.line([cx, cy - 0.02 * s, cx - 0.04 * s, cy + 0.12 * s], fill=(150, 90, 70), width=max(1, s // 40))
        d.ellipse([cx - 0.14 * s, cy + 0.22 * s, cx + 0.14 * s, cy + 0.3 * s], fill=(160, 60, 60))
    return np.array(img), boxes


def photo(seed: int, index: int, hw, faces: int, face_px) -> np.ndarray:
    """Photo ``index`` of a run seeded by ``seed``: the same pair gives the
    same pixels, and every seed gives the same sizes and face counts."""
    rng = np.random.default_rng([int(seed) % (1 << 64), int(index)])
    return faces_with_boxes(natural_background(hw[0], hw[1], rng), faces, face_px, rng)[0]


def rgb_to_yuv420(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 RGB [H, W, 3] -> (Y [H, W], UV [H/2, W/2, 2]) uint8 (even sizes)."""
    f = img.astype(np.float32)
    y = f @ RGB_TO_YCC[0]
    cb = f @ RGB_TO_YCC[1] + 128.0
    cr = f @ RGB_TO_YCC[2] + 128.0
    hh, ww = cb.shape[0] // 2, cb.shape[1] // 2
    cb = cb.reshape(hh, 2, ww, 2).mean(axis=(1, 3))
    cr = cr.reshape(hh, 2, ww, 2).mean(axis=(1, 3))
    y8 = np.clip(np.rint(y), 0, 255).astype(np.uint8)
    uv8 = np.clip(np.rint(np.stack([cb, cr], axis=-1)), 0, 255).astype(np.uint8)
    return y8, uv8


def _quantize_plane(plane: np.ndarray, q: np.ndarray):
    h, w = plane.shape
    blocks = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    c = dct_matrix()
    coef = np.einsum("ij,byjk,lk->byil", c, blocks, c)
    cq = np.round(coef.reshape(*coef.shape[:2], 64) / q)
    dc = np.clip(cq[..., 0], -(1 << 15), (1 << 15) - 1).astype(np.int16)
    ac = np.clip(cq, -127, 127).astype(np.int8)
    ac[..., 0] = 0
    return dc, ac


def encode_dct420(img: np.ndarray, quality: int = 90) -> dict:
    """uint8 RGB [H, W, 3] (H, W multiples of 16) -> the quantized 4:2:0 DCT
    planes as a dict of the fields of the program's ``DctImage``."""
    h, w = img.shape[:2]
    if h % 16 or w % 16:
        raise ValueError(f"the benchmark encodes images whose sides are multiples of 16, not {(h, w)}")
    y, uv = rgb_to_yuv420(img)
    qy, qc = quality_tables(quality)
    y_dc, y_ac = _quantize_plane(y.astype(np.float32) - 128.0, qy)
    u_dc, u_ac = _quantize_plane(uv[..., 0].astype(np.float32) - 128.0, qc)
    v_dc, v_ac = _quantize_plane(uv[..., 1].astype(np.float32) - 128.0, qc)
    return dict(y_dc=y_dc, y_ac=y_ac, uv_dc=np.stack([u_dc, v_dc], 2), uv_ac=np.stack([u_ac, v_ac], 2),
                qy=qy, qc=qc, hw=(h, w))
