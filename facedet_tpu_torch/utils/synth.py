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


def bench_image(h: int, w: int) -> np.ndarray:
    """The root ``bench.py``'s ``_make_image``, copied bit for bit: the
    [h, w, 3] uint8 natural-statistics test image (smooth noise at three
    scales, seed 0) that the JAX profile tools and probes time on."""
    rng = np.random.default_rng(0)
    base = np.zeros((h, w), np.float32)
    for octave in (8, 32, 128):
        up = np.kron(
            rng.standard_normal((octave, octave)).astype(np.float32),
            np.ones((-(-h // octave), -(-w // octave)), np.float32),
        )[:h, :w]
        base += up / octave**0.5
    base = (base - base.min()) / (base.max() - base.min())
    return np.stack([base * 255, base * 230 + 10, base * 210 + 25], -1).astype(np.uint8)


def synthetic_faces(h: int, w: int, seed: int = 0, n: int = 6, size=(50, 140), background=None) -> np.ndarray:
    """[h, w, 3] uint8 RGB image holding ``n`` faces of ``size`` px, drawn
    on white noise or on the ``background`` image given."""
    return synthetic_faces_with_boxes(h, w, seed, n, size, background)[0]


def synthetic_faces_with_boxes(h: int, w: int, seed: int = 0, n: int = 6, size=(50, 140), background=None):
    """``synthetic_faces`` and each face's box: (image, boxes [n, 4] xyxy
    float64), the box spanning the face ellipse and the hair,
    ``[cx - 0.45 s, cy - 0.75 s, cx + 0.45 s, cy + 0.55 s]``."""
    rng = np.random.default_rng(seed)
    if background is None:
        background = rng.integers(60, 120, (h, w, 3), dtype=np.uint8)
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


# the reference's landmark dot colours as RGB (its BGR draws read back):
# left eye, right eye, nose, left mouth corner, right mouth corner
KEYPOINT_DOT_COLORS = [(0, 0, 255), (0, 255, 0), (255, 0, 0), (0, 255, 255), (255, 0, 255)]


def face_landmarks(boxes: np.ndarray) -> np.ndarray:
    """The five landmarks [n, 5, 2] of ``synthetic_faces_with_boxes``'s faces,
    from their boxes: the eye centres, the nose tip, the mouth corners (the
    image's left one first)."""
    boxes = np.asarray(boxes, np.float64)
    s = (boxes[:, 2] - boxes[:, 0]) / 0.9
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = boxes[:, 1] + 0.75 * s
    offsets = np.array([(-0.17, -0.08), (0.17, -0.08), (-0.02, 0.08), (-0.14, 0.26), (0.14, 0.26)])
    return np.stack([cx[:, None] + offsets[None, :, 0] * s[:, None],
                     cy[:, None] + offsets[None, :, 1] * s[:, None]], -1)


def _separate_faces(hw, n: int, size, rng: np.random.Generator, gap: int = 16):
    """``synthetic_faces_with_boxes`` one face at a time on one noise
    background, each placement redrawn until its box lies ``gap`` px clear of
    the others (a face's dots and outline stay out of its neighbours' boxes).
    Returns (image, boxes [n, 4])."""
    img = rng.integers(60, 120, (hw[0], hw[1], 3), dtype=np.uint8)
    boxes = np.zeros((0, 4))
    while len(boxes) < n:
        cand, b = synthetic_faces_with_boxes(hw[0], hw[1], seed=int(rng.integers(2**31)), n=1, size=size,
                                             background=img)
        if all(b[0, 0] > o[2] + gap or b[0, 2] < o[0] - gap or b[0, 1] > o[3] + gap or b[0, 3] < o[1] - gap
               for o in boxes):
            img, boxes = cand, np.concatenate([boxes, b])
    return img, boxes


def synthetic_reference_tree(root: str, n_images: int = 6, hw=(1024, 1536), n_faces: int = 12,
                             size=(50, 140), seed: int = 0, subdir: str = "temp_streamlit") -> dict:
    """Write a tree laid out as the reference's committed run artifacts and
    return what it holds. For each image ``<root>/<subdir>/<name>/``:
    ``temp_sahi_input.jpg`` (``synthetic_faces_with_boxes``' faces, apart
    from each other), one crop per
    face cut at its integer box as ``crops/<name>_face_<i>_conf_<c:.2f>.jpg``
    (a seeded confidence in [0.1, 0.95]) and ``<name>_detail.jpg``: the image
    with each box outlined in green and each landmark a radius-2 dot of the
    reference's colour inside a white ring.

    Returns ``{"<subdir>/<name>": {"boxes": int [n, 4] xyxy, "conf": [n],
    "kpts": int [n, 5, 2] dot centres}}``, the exact answer of the recovery
    tools (tools/reference_goldens.py, tools/golden_keypoints.py)."""
    import os

    rng = np.random.default_rng(seed)
    truth = {}
    for k in range(n_images):
        name = f"{k}_Synthetic_faces_{k}"
        d = os.path.join(root, subdir, name)
        os.makedirs(os.path.join(d, "crops"), exist_ok=True)
        img, boxes = _separate_faces(hw, n_faces, size, rng)
        Image.fromarray(img).save(os.path.join(d, "temp_sahi_input.jpg"), quality=95)
        ib = np.round(boxes).astype(int)
        ib[:, 0::2] = np.clip(ib[:, 0::2], 0, hw[1])
        ib[:, 1::2] = np.clip(ib[:, 1::2], 0, hw[0])
        conf = np.round(rng.uniform(0.1, 0.95, len(ib)), 2)
        for i, (x1, y1, x2, y2) in enumerate(ib):
            Image.fromarray(img[y1:y2, x1:x2]).save(
                os.path.join(d, "crops", f"{name}_face_{i}_conf_{conf[i]:.2f}.jpg"), quality=95)
        kpts = np.round(face_landmarks(boxes)).astype(int)
        detail = Image.fromarray(img)
        draw = ImageDraw.Draw(detail)
        for (x1, y1, x2, y2), pts in zip(ib, kpts):
            draw.rectangle([x1, y1, x2, y2], outline=(0, 255, 0), width=2)
            for (x, y), color in zip(pts, KEYPOINT_DOT_COLORS):
                draw.ellipse([x - 3, y - 3, x + 3, y + 3], fill=(255, 255, 255))
                draw.ellipse([x - 2, y - 2, x + 2, y + 2], fill=color)
        detail.save(os.path.join(d, f"{name}_detail.jpg"), quality=95)
        truth[f"{subdir}/{name}"] = {"boxes": ib, "conf": [float(c) for c in conf], "kpts": kpts}
    return truth
