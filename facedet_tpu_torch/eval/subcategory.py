"""6-subcategory face classifier ({small,medium,large} x {clear,degraded}).

Reference: scripts/classifier_face_level_2.py:7-438 — parses
``wider_face_val_bbx_gt.txt``, classifies each face by size
(max(w,h): small < 50 <= medium < 150 <= large) and degradation
(blur>=1 or occlusion>=1 or illumination==1 or pose==1), and emits
``subcategory_gt.json`` with per-image ``all_faces`` + per-category index
lists (:205-291) plus a statistics report (:293-387). Also provides the
category query helpers of scripts/check_image_category.py and
scripts/find_images_by_category.py.

A copy of facedet_tpu/eval/subcategory.py (host code).
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Optional

from facedet_tpu_torch.data.widerface import FaceAnnotation, parse_wider_gt_txt

CATEGORIES = [
    "large_clear",
    "large_degraded",
    "medium_clear",
    "medium_degraded",
    "small_clear",
    "small_degraded",
]

SMALL_THRESHOLD = 50.0
LARGE_THRESHOLD = 150.0

# Official-setting reconstruction from subcategories (eval/eval_dual.py:458-462)
DIFFICULTY_MAPPING = {
    "easy": ["large_clear"],
    "medium": ["large_clear", "large_degraded", "medium_clear"],
    "hard": list(CATEGORIES),
}


def classify_face(
    face: FaceAnnotation,
    small_threshold: float = SMALL_THRESHOLD,
    large_threshold: float = LARGE_THRESHOLD,
) -> Optional[str]:
    """One face -> category name, or None for invalid faces
    (scripts/classifier_face_level_2.py:163-203)."""
    if face.invalid == 1:
        return None
    w, h = face.bbox[2], face.bbox[3]
    if w <= 0 or h <= 0:
        return None
    size = max(w, h)
    if size < small_threshold:
        size_cat = "small"
    elif size < large_threshold:
        size_cat = "medium"
    else:
        size_cat = "large"
    degraded = (
        face.blur >= 1
        or face.occlusion >= 1
        or face.illumination == 1
        or face.pose == 1
    )
    return f"{size_cat}_{'degraded' if degraded else 'clear'}"


def create_subcategory_annotations(
    annotations: dict[str, list[FaceAnnotation]],
    small_threshold: float = SMALL_THRESHOLD,
    large_threshold: float = LARGE_THRESHOLD,
) -> dict:
    """{image: faces} -> subcategory_gt structure
    (scripts/classifier_face_level_2.py:205-291)."""
    data: dict[str, dict] = {}
    for img_path, faces in annotations.items():
        all_faces = []
        category_indices: dict[str, list[int]] = {c: [] for c in CATEGORIES}
        for face in faces:
            cat = classify_face(face, small_threshold, large_threshold)
            entry = {
                "bbox": list(face.bbox),
                "category": cat,
                "size": max(face.bbox[2], face.bbox[3]),
                "attributes": face.attributes,
            }
            idx = len(all_faces)
            all_faces.append(entry)
            if cat is not None:
                category_indices[cat].append(idx)
        data[img_path] = {"all_faces": all_faces, **category_indices}
    return data


def compute_statistics(subcategory_data: dict) -> dict:
    """Aggregate counts per category (scripts/classifier_face_level_2.py:293-387)."""
    counts: dict[str, int] = defaultdict(int)
    total_faces = 0
    invalid = 0
    for entry in subcategory_data.values():
        for face in entry["all_faces"]:
            total_faces += 1
            if face["category"] is None:
                invalid += 1
            else:
                counts[face["category"]] += 1
    valid = total_faces - invalid
    return {
        "total_images": len(subcategory_data),
        "total_faces": total_faces,
        "valid_faces": valid,
        "invalid_faces": invalid,
        "per_category": {
            c: {
                "count": counts[c],
                "percent": 100.0 * counts[c] / valid if valid else 0.0,
            }
            for c in CATEGORIES
        },
    }


def build_subcategory_gt(
    gt_txt: str,
    output_json: Optional[str] = None,
    small_threshold: float = SMALL_THRESHOLD,
    large_threshold: float = LARGE_THRESHOLD,
) -> dict:
    """Full pipeline: GT txt -> subcategory_gt.json + stats."""
    annotations = parse_wider_gt_txt(gt_txt)
    data = create_subcategory_annotations(annotations, small_threshold, large_threshold)
    stats = compute_statistics(data)
    if output_json:
        os.makedirs(os.path.dirname(os.path.abspath(output_json)), exist_ok=True)
        with open(output_json, "w") as f:
            json.dump(data, f)
    return {"data": data, "statistics": stats}


def check_image_category(subcategory_data: dict, image_path: str) -> dict:
    """Per-image category breakdown (scripts/check_image_category.py)."""
    entry = subcategory_data.get(image_path)
    if entry is None:
        matches = [k for k in subcategory_data if image_path in k]
        if not matches:
            return {"found": False}
        entry = subcategory_data[matches[0]]
        image_path = matches[0]
    return {
        "found": True,
        "image": image_path,
        "num_faces": len(entry["all_faces"]),
        "categories": {c: len(entry[c]) for c in CATEGORIES},
    }


def find_images_by_category(
    subcategory_data: dict, category: str, min_faces: int = 1
) -> list[tuple[str, int]]:
    """Images containing >= min_faces of a category, sorted by count desc
    (scripts/find_images_by_category.py)."""
    if category not in CATEGORIES:
        raise ValueError(f"unknown category {category!r}; expected one of {CATEGORIES}")
    hits = [
        (img, len(entry[category]))
        for img, entry in subcategory_data.items()
        if len(entry[category]) >= min_faces
    ]
    return sorted(hits, key=lambda t: -t[1])
