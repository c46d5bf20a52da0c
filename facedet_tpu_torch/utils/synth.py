"""Seeded synthetic face images for smoke runs and parity tests.

Cartoon faces (skin ellipse, hair, eyes, nose, mouth) on a noisy or a
photo-like background, drawn with PIL: the golden YOLOv11-pose checkpoint fires on
them, so a run with random-free inputs still has detections to compare.
"""
from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw


def natural_background(h: int, w: int, seed: int = 0) -> np.ndarray:
    """[h, w, 3] uint8 background with photo-like statistics: smooth noise
    at three scales plus a little sensor noise. Its quantized DCT planes are
    mostly zeros, as a photograph's are; white noise is the worst case."""
    rng = np.random.default_rng(seed)
    base = np.zeros((h, w), np.float32)
    for octave in (8, 32, 128):
        up = np.kron(
            rng.standard_normal((octave, octave)).astype(np.float32),
            np.ones((-(-h // octave), -(-w // octave)), np.float32),
        )[:h, :w]
        base += up / octave**0.5
    base = (base - base.min()) / (base.max() - base.min())
    rgb = np.stack([base * 110 + 40, base * 100 + 45, base * 90 + 50], -1)
    rgb += rng.normal(0.0, 1.5, (h, w, 1)).astype(np.float32)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def synthetic_faces(h: int, w: int, seed: int = 0, n: int = 6, size=(50, 140), background=None) -> np.ndarray:
    """[h, w, 3] uint8 RGB image holding ``n`` faces of ``size`` px, drawn
    on white noise or on the ``background`` image given."""
    rng = np.random.default_rng(seed)
    if background is None:
        background = rng.integers(60, 120, (h, w, 3), dtype=np.uint8)
    img = Image.fromarray(background)
    d = ImageDraw.Draw(img)
    for _ in range(n):
        s = int(rng.integers(*size))
        cx = int(rng.integers(s, w - s))
        cy = int(rng.integers(s, h - s))
        skin = tuple(int(v) for v in rng.integers([180, 120, 90], [235, 170, 140]))
        d.ellipse([cx - 0.4 * s, cy - 0.55 * s, cx + 0.4 * s, cy + 0.55 * s], fill=skin)
        d.ellipse([cx - 0.45 * s, cy - 0.75 * s, cx + 0.45 * s, cy - 0.3 * s], fill=(40, 30, 20))
        for ex in (-0.17, 0.17):
            ox = cx + ex * s
            d.ellipse([ox - 0.07 * s, cy - 0.12 * s, ox + 0.07 * s, cy - 0.04 * s], fill=(255, 255, 255))
            d.ellipse([ox - 0.035 * s, cy - 0.11 * s, ox + 0.035 * s, cy - 0.05 * s], fill=(30, 20, 20))
        d.line([cx, cy - 0.02 * s, cx - 0.04 * s, cy + 0.12 * s], fill=(150, 90, 70), width=max(1, s // 40))
        d.ellipse([cx - 0.14 * s, cy + 0.22 * s, cx + 0.14 * s, cy + 0.3 * s], fill=(160, 60, 60))
    return np.array(img)
