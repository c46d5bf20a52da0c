"""WIDERFACE ground-truth parsing and dataset converters.

Reference parity:
  * GT txt parsing — scripts/classifier_face_level_2.py:42-115 (10-field
    annotation format: x y w h blur expression illumination invalid occlusion pose)
  * official .mat GT loading — eval/eval_official_widerface.py:121-143
  * WIDERFACE -> YOLO label conversion with invalid-flag filter + clipping —
    pipeline_v3_RTDETR/convert_widerface.py:5-121
  * WIDERFACE -> COCO JSON — scripts/convert_yolo_to_coco.py:87-226

A copy of facedet_tpu/data/widerface.py (host numpy, no device code).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

ATTR_FIELDS = ("blur", "expression", "illumination", "invalid", "occlusion", "pose")


@dataclasses.dataclass
class FaceAnnotation:
    bbox: tuple[float, float, float, float]  # x, y, w, h
    blur: int = 0
    expression: int = 0
    illumination: int = 0
    invalid: int = 0
    occlusion: int = 0
    pose: int = 0

    @property
    def attributes(self) -> dict:
        return {k: getattr(self, k) for k in ATTR_FIELDS}


def parse_wider_gt_txt(path: str) -> dict[str, list[FaceAnnotation]]:
    """Parse ``wider_face_{split}_bbx_gt.txt``.

    Format per image: path line, count line, then ``count`` annotation lines
    (or one all-zero line when count == 0). Tolerates the malformed files
    that utils/fix_predictions.py exists to repair."""
    annotations: dict[str, list[FaceAnnotation]] = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        img_path = lines[i]
        i += 1
        if i >= len(lines):
            break
        try:
            count = int(lines[i])
            i += 1
        except ValueError:
            # missing count line: infer by reading annotation-shaped lines
            count = -1
        faces: list[FaceAnnotation] = []
        if count == 0:
            # zero-face images still carry one placeholder line
            if i < len(lines) and lines[i].split()[:1] and not lines[i].endswith(".jpg"):
                i += 1
        else:
            n = 0
            while i < len(lines) and (count < 0 or n < count):
                parts = lines[i].split()
                if count < 0 and (len(parts) < 4 or lines[i].endswith(".jpg")):
                    break
                vals = [float(v) for v in parts[:4]]
                attrs = [int(float(v)) for v in parts[4:10]] + [0] * max(0, 6 - len(parts[4:10]))
                faces.append(FaceAnnotation(tuple(vals), *attrs[:6]))
                i += 1
                n += 1
        annotations[img_path] = faces
    return annotations


def load_official_mat_gt(gt_dir: str) -> dict:
    """Load the official .mat protocol files (eval/eval_official_widerface.py:121-143).

    Returns dict with event_list, file_list, facebox_list and per-setting
    gt (keep-index) lists. Requires scipy."""
    from scipy.io import loadmat  # gated: host-side eval only

    gt = loadmat(os.path.join(gt_dir, "wider_face_val.mat"))
    out = {
        "event_list": gt["event_list"],
        "file_list": gt["file_list"],
        "facebox_list": gt["face_bbx_list"],
        "setting_gts": {},
    }
    for setting in ("easy", "medium", "hard"):
        m = loadmat(os.path.join(gt_dir, f"wider_{setting}_val.mat"))
        out["setting_gts"][setting] = m["gt_list"]
    return out


def gt_txt_to_prediction_structures(
    annotations: dict[str, list[FaceAnnotation]]
) -> dict:
    """Build event/file/box structures equivalent to the .mat layout from the
    txt GT, so the official evaluator runs without scipy/.mat files. All GT
    boxes are kept (no setting filter) — use the subcategory classifier for
    Easy/Medium/Hard-like splits in that case."""
    events: dict[str, dict[str, np.ndarray]] = {}
    for img_path, faces in annotations.items():
        event = img_path.split("/")[0]
        name = os.path.splitext(os.path.basename(img_path))[0]
        boxes = np.array([f.bbox for f in faces], np.float64).reshape(-1, 4)
        events.setdefault(event, {})[name] = boxes
    return events


def gt_txt_to_keep_lists(
    annotations: dict[str, list[FaceAnnotation]]
) -> dict:
    """1-based keep-index lists (the .mat ``gt_list`` analog) from the txt
    GT's ``invalid`` flag: faces marked invalid==1 become ignore regions —
    the official matcher (eval/eval_official_widerface.py:214-249 semantics)
    neither rewards nor penalises detections on them and excludes them from
    the recall denominator."""
    keeps: dict[str, dict[str, np.ndarray]] = {}
    for img_path, faces in annotations.items():
        event = img_path.split("/")[0]
        name = os.path.splitext(os.path.basename(img_path))[0]
        idx = np.array([i + 1 for i, f in enumerate(faces) if not f.invalid], int)
        keeps.setdefault(event, {})[name] = idx
    return keeps


def convert_widerface_to_yolo(
    gt_txt: str,
    images_dir: str,
    labels_dir: str,
    image_sizes: Optional[dict[str, tuple[int, int]]] = None,
    filter_invalid: bool = True,
    min_size: float = 1.0,
) -> dict:
    """GT txt -> per-image YOLO label files (class cx cy w h, normalized).

    Robust variant semantics (pipeline_v3_RTDETR/convert_widerface.py:5-121):
    drops invalid==1 and non-positive boxes, clips to image bounds. Image
    sizes come from ``image_sizes`` (h, w) or are read from disk via PIL."""
    os.makedirs(labels_dir, exist_ok=True)
    ann = parse_wider_gt_txt(gt_txt)
    stats = {"images": 0, "labels": 0, "skipped_faces": 0, "missing_images": 0}
    for img_path, faces in ann.items():
        if image_sizes is not None and img_path in image_sizes:
            h, w = image_sizes[img_path]
        else:
            full = os.path.join(images_dir, img_path)
            if not os.path.exists(full):
                stats["missing_images"] += 1
                continue
            from PIL import Image

            with Image.open(full) as im:
                w, h = im.size
        lines = []
        for f in faces:
            x, y, bw, bh = f.bbox
            if filter_invalid and f.invalid == 1:
                stats["skipped_faces"] += 1
                continue
            if bw < min_size or bh < min_size:
                stats["skipped_faces"] += 1
                continue
            x1, y1 = max(0.0, x), max(0.0, y)
            x2, y2 = min(float(w), x + bw), min(float(h), y + bh)
            if x2 - x1 < min_size or y2 - y1 < min_size:
                stats["skipped_faces"] += 1
                continue
            cx, cy = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
            nw, nh = (x2 - x1) / w, (y2 - y1) / h
            lines.append(f"0 {cx:.6f} {cy:.6f} {nw:.6f} {nh:.6f}")
            stats["labels"] += 1
        label_name = os.path.splitext(img_path.replace("/", "_"))[0] + ".txt"
        with open(os.path.join(labels_dir, label_name), "w") as fh:
            fh.write("\n".join(lines))
        stats["images"] += 1
    return stats


def convert_widerface_to_coco(
    gt_txt: str,
    images_dir: str,
    output_json: str,
    image_sizes: Optional[dict[str, tuple[int, int]]] = None,
    filter_invalid: bool = True,
) -> dict:
    """GT txt -> COCO JSON with category {id: 0, name: face}
    (scripts/convert_yolo_to_coco.py:125-226)."""
    ann = parse_wider_gt_txt(gt_txt)
    images, annotations = [], []
    ann_id = 1
    for img_id, (img_path, faces) in enumerate(sorted(ann.items()), start=1):
        if image_sizes is not None and img_path in image_sizes:
            h, w = image_sizes[img_path]
        else:
            full = os.path.join(images_dir, img_path)
            if not os.path.exists(full):
                continue
            from PIL import Image

            with Image.open(full) as im:
                w, h = im.size
        images.append({"id": img_id, "file_name": img_path, "width": w, "height": h})
        for f in faces:
            x, y, bw, bh = f.bbox
            if filter_invalid and f.invalid == 1:
                continue
            if bw <= 0 or bh <= 0:
                continue
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": 0,
                    "bbox": [x, y, bw, bh],
                    "area": bw * bh,
                    "iscrowd": 0,
                }
            )
            ann_id += 1
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": 0, "name": "face"}],
    }
    os.makedirs(os.path.dirname(os.path.abspath(output_json)), exist_ok=True)
    with open(output_json, "w") as f:
        json.dump(coco, f)
    return {"images": len(images), "annotations": len(annotations)}


def create_dataset_yaml(
    path: str, dataset_root: str, train: str = "images/train", val: str = "images/val"
) -> str:
    """YOLO dataset yaml (reference pipeline_v3_RTDETR/train_rtdetr.py:85-101,
    widerface.yaml:1-5)."""
    content = (
        f"path: {dataset_root}\n"
        f"train: {train}\n"
        f"val: {val}\n"
        "nc: 1\n"
        "names: ['face']\n"
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(content)
    return path


def fix_prediction_file(path: str, output_path: Optional[str] = None) -> bool:
    """Repair WIDERFACE submission .txt missing the count line
    (reference utils/fix_predictions.py:4-56)."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    if len(lines) >= 2:
        try:
            int(lines[1])
            return False  # already well-formed
        except ValueError:
            pass
    n_boxes = max(0, len(lines) - 1)
    fixed = [lines[0] if lines else "", str(n_boxes)] + lines[1:]
    with open(output_path or path, "w") as f:
        f.write("\n".join(fixed) + "\n")
    return True
