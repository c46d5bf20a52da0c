"""Host-side visualisation: boxes, 5-keypoint skeleton, crops, summaries.

Reference parity: utils/visualization.py (keypoint schema :7-35,
draw_detections :78, draw_detections_on_image :151, save_face_crops :185,
create_detection_summary :225) and the matplotlib twin docs sahi/visualization.py.
OpenCV is replaced by PIL + numpy. A copy of facedet_tpu/utils/viz.py.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

try:
    from PIL import Image, ImageDraw
except ImportError:  # pragma: no cover
    Image = ImageDraw = None

# 5-keypoint facial schema (reference utils/visualization.py:7-35)
KEYPOINT_NAMES = ["left_eye", "right_eye", "nose", "left_mouth", "right_mouth"]
KEYPOINT_COLORS = [
    (0, 255, 0),
    (0, 255, 255),
    (255, 0, 255),
    (255, 128, 0),
    (0, 128, 255),
]
SKELETON = [(0, 1), (0, 2), (1, 2), (2, 3), (2, 4), (3, 4)]
BOX_COLOR = (255, 0, 0)
KPT_CONF_THRESHOLD = 0.3


def _require_pil():
    if Image is None:  # pragma: no cover
        raise ImportError("Pillow is required for visualization")


def load_image(path: str) -> np.ndarray:
    _require_pil()
    return np.asarray(Image.open(path).convert("RGB"))


def save_image(path: str, image: np.ndarray, quality: int = 95) -> None:
    _require_pil()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(np.asarray(image, np.uint8)).save(path, quality=quality)


def draw_keypoints_and_skeleton(
    draw: "ImageDraw.ImageDraw", kpts: np.ndarray, radius: int = 2
) -> None:
    """kpts [5,3] (x, y, conf) — reference utils/visualization.py:37."""
    vis = kpts[:, 2] > KPT_CONF_THRESHOLD
    for a, b in SKELETON:
        if vis[a] and vis[b]:
            draw.line(
                [tuple(kpts[a, :2]), tuple(kpts[b, :2])], fill=(255, 255, 0), width=1
            )
    for i, (x, y, c) in enumerate(kpts):
        if c > KPT_CONF_THRESHOLD:
            draw.ellipse(
                [x - radius, y - radius, x + radius, y + radius],
                fill=KEYPOINT_COLORS[i % len(KEYPOINT_COLORS)],
            )


def draw_detections_on_image(
    image: np.ndarray,
    predictions: Sequence,
    with_keypoints: bool = True,
    with_labels: bool = True,
    box_color: tuple = BOX_COLOR,
) -> np.ndarray:
    """Array -> annotated array (reference utils/visualization.py:151)."""
    _require_pil()
    img = Image.fromarray(np.asarray(image, np.uint8)).convert("RGB")
    draw = ImageDraw.Draw(img)
    for p in predictions:
        x1, y1, x2, y2 = p.bbox.to_xyxy()
        draw.rectangle([x1, y1, x2, y2], outline=box_color, width=2)
        if with_labels:
            label = f"{p.category.name} {p.score.value:.2f}"
            draw.text((x1 + 1, max(0, y1 - 11)), label, fill=box_color)
        if with_keypoints and getattr(p, "keypoints", None) is not None:
            draw_keypoints_and_skeleton(draw, np.asarray(p.keypoints))
    return np.asarray(img)


def draw_detections(
    image_path: str,
    predictions: Sequence,
    output_path: str,
    **kwargs,
) -> str:
    """File -> file (reference utils/visualization.py:78)."""
    img = load_image(image_path)
    vis = draw_detections_on_image(img, predictions, **kwargs)
    save_image(output_path, vis)
    return output_path


def save_face_crops(
    image: np.ndarray,
    predictions: Sequence,
    output_dir: str,
    prefix: str = "face",
    margin: int = 0,
) -> list[str]:
    """Crop each detection to ``{prefix}_{i}_conf_{score:.2f}.jpg``
    (reference utils/visualization.py:185-223)."""
    _require_pil()
    os.makedirs(output_dir, exist_ok=True)
    img = np.asarray(image)
    h, w = img.shape[:2]
    paths = []
    for i, p in enumerate(predictions, start=1):
        x1, y1, x2, y2 = (int(round(v)) for v in p.bbox.to_xyxy())
        x1, y1 = max(0, x1 - margin), max(0, y1 - margin)
        x2, y2 = min(w, x2 + margin), min(h, y2 + margin)
        if x2 <= x1 or y2 <= y1:
            continue
        path = os.path.join(output_dir, f"{prefix}_{i}_conf_{p.score.value:.2f}.jpg")
        save_image(path, img[y1:y2, x1:x2])
        paths.append(path)
    return paths


def create_detection_summary(
    predictions: Sequence,
    image_name: str = "",
    output_path: Optional[str] = None,
    extra_info: Optional[dict] = None,
) -> str:
    """Text report with per-face keypoints (reference utils/visualization.py:225-285)."""
    lines = [
        "DETECTION SUMMARY",
        "=" * 40,
        f"Image: {image_name}",
        f"Total faces detected: {len(predictions)}",
        "",
    ]
    for i, p in enumerate(predictions, start=1):
        x1, y1, x2, y2 = p.bbox.to_xyxy()
        lines.append(
            f"Face {i}: conf={p.score.value:.3f} "
            f"bbox=[{x1:.1f}, {y1:.1f}, {x2:.1f}, {y2:.1f}] "
            f"size={x2 - x1:.0f}x{y2 - y1:.0f}"
        )
        kpts = getattr(p, "keypoints", None)
        if kpts is not None:
            for name, (x, y, c) in zip(KEYPOINT_NAMES, np.asarray(kpts)):
                if c > KPT_CONF_THRESHOLD:
                    lines.append(f"  {name}: ({x:.1f}, {y:.1f}) conf={c:.2f}")
    if extra_info:
        lines.append("")
        for k, v in extra_info.items():
            lines.append(f"{k}: {v}")
    report = "\n".join(lines)
    if output_path:
        os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
        with open(output_path, "w") as f:
            f.write(report)
    return report
