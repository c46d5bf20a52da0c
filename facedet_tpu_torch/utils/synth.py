"""Seeded synthetic face images for smoke runs and parity tests.

Cartoon faces (skin ellipse, hair, eyes, nose, mouth) on a noisy
background, drawn with PIL: the golden YOLOv11-pose checkpoint fires on
them, so a run with random-free inputs still has detections to compare.
"""
from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw


def synthetic_faces(h: int, w: int, seed: int = 0, n: int = 6, size=(50, 140)) -> np.ndarray:
    """[h, w, 3] uint8 RGB image holding ``n`` faces of ``size`` px."""
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(60, 120, (h, w, 3), dtype=np.uint8))
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
