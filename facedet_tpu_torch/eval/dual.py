"""Dual evaluator: 6 subcategories + reconstructed Easy/Medium/Hard.

Reference: eval/eval_dual.py:21-726 — evaluates the same predictions against
(a) each of the 6 subcategories and (b) official-style difficulties rebuilt
from the subcategory mapping (easy={large_clear}, medium={large_clear,
large_degraded, medium_clear}, hard=all, :458-462). Per-image greedy IoU
matching with an ignore list (:376-409), 11-point-interpolated AP (:293-315),
precision/recall/F1 at a global confidence of 0.25 (:68,414-420), a
prediction cache shared across the 9 evaluation passes (:86,186-189), JSON
results (:560-608) and a 3-panel bar chart (:610-682).

A copy of facedet_tpu/eval/dual.py (host float64 numpy).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np

from facedet_tpu_torch.eval.subcategory import CATEGORIES, DIFFICULTY_MAPPING

__all__ = [
    "calculate_iou",
    "iou_matrix_xywh",
    "average_precision_11pt",
    "DualWiderFaceEvaluator",
]


def calculate_iou(box1, box2) -> float:
    """xywh IoU (eval/eval_dual.py:270-291)."""
    x1, y1, w1, h1 = box1
    x2, y2, w2, h2 = box2
    ix1, iy1 = max(x1, x2), max(y1, y2)
    ix2, iy2 = min(x1 + w1, x2 + w2), min(y1 + h1, y2 + h2)
    if ix2 < ix1 or iy2 < iy1:
        return 0.0
    inter = (ix2 - ix1) * (iy2 - iy1)
    union = w1 * h1 + w2 * h2 - inter
    return inter / union if union > 0 else 0.0


def iou_matrix_xywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[P, G] IoU matrix between xywh boxes — the vectorised form of
    :func:`calculate_iou` (same math, no +1 inclusive-pixel convention; that
    convention belongs to the official evaluator's ``bbox_overlaps``)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 0] + a[:, None, 2], b[None, :, 0] + b[None, :, 2])
    iy2 = np.minimum(a[:, None, 1] + a[:, None, 3], b[None, :, 1] + b[None, :, 3])
    # calculate_iou returns 0 only for a STRICT gap (ix2 < ix1); a degenerate
    # zero-area touch yields inter == 0 either way, so clip matches exactly
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    inter[(ix2 < ix1) | (iy2 < iy1)] = 0.0
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(union > 0, inter / np.maximum(union, 1e-300), 0.0)
    return out


def average_precision_11pt(detections: list[dict], total_gt: int) -> float:
    """11-point interpolated AP over {confidence, is_tp} records
    (eval/eval_dual.py:293-315)."""
    if total_gt == 0 or not detections:
        return 0.0
    detections = sorted(detections, key=lambda d: d["confidence"], reverse=True)
    tp = np.cumsum([d["is_tp"] for d in detections])
    fp = np.cumsum([not d["is_tp"] for d in detections])
    recalls = tp / total_gt
    precisions = tp / (tp + fp)
    ap = 0.0
    for t in np.arange(0.0, 1.1, 0.1):
        mask = recalls >= t
        ap += (np.max(precisions[mask]) if mask.any() else 0.0) / 11.0
    return float(ap)


class DualWiderFaceEvaluator:
    """Reference eval/eval_dual.py:21. ``predict_fn(image_path) -> [P,5]``
    xywh+score supplies inference; results are cached per path so each image
    is inferred once across all 9 passes (:86,186-189)."""

    def __init__(
        self,
        predict_fn: Callable[[str], np.ndarray],
        subcategory_gt: dict,
        images_path: str = "",
        iou_threshold: float = 0.5,
        global_confidence: float = 0.25,
        output_dir: str = "output",
        mode_string: str = "dual-eval",
    ):
        self.predict_fn = predict_fn
        self.subcategory_gt = subcategory_gt
        self.images_path = images_path
        self.iou_threshold = iou_threshold
        self.global_confidence = global_confidence
        self.output_dir = output_dir
        self.mode_string = mode_string
        self.prediction_cache: dict[str, np.ndarray] = {}
        self.subcategories = list(CATEGORIES)
        self.difficulties = ["easy", "medium", "hard"]

    def run_inference(self, img_path: str) -> np.ndarray:
        if img_path not in self.prediction_cache:
            self.prediction_cache[img_path] = np.asarray(
                self.predict_fn(img_path), float
            ).reshape(-1, 5)
        return self.prediction_cache[img_path]

    def evaluate_single_set(self, set_name: str, categories: list[str]) -> dict:
        """Evaluate predictions against the GT faces of ``categories``; other
        valid categories act as an ignore list (eval/eval_dual.py:370-465)."""
        all_detections: list[dict] = []
        total_gt = 0
        false_negatives = 0
        for img_path, entry in self.subcategory_gt.items():
            faces = entry["all_faces"]
            gt_faces = [
                f for f in faces if f["category"] in categories and f["category"]
            ]
            ignored_faces = [
                f
                for f in faces
                if f["category"] not in categories or f["category"] is None
            ]
            total_gt += len(gt_faces)
            full_path = os.path.join(self.images_path, img_path)
            pred_boxes = self.run_inference(full_path)

            # vectorised matcher: one [P, G] and one [P, I] IoU matrix per
            # image replace the reference's per-pair Python loops
            # (eval/eval_dual.py:376-409) — same greedy semantics: each pred
            # claims its single best-IoU GT (argmax over ALL GT, matched or
            # not); a pred whose best GT is taken is an FP, never re-assigned.
            gt_matched = [False] * len(gt_faces)
            order = np.argsort(-pred_boxes[:, 4], kind="stable")
            gt_arr = np.asarray([f["bbox"] for f in gt_faces], np.float64)
            ign_arr = np.asarray([f["bbox"] for f in ignored_faces], np.float64)
            iou_gt = iou_matrix_xywh(pred_boxes[:, :4], gt_arr)
            hits_ignored = (
                iou_matrix_xywh(pred_boxes[:, :4], ign_arr) >= self.iou_threshold
            ).any(axis=1)
            best_idx_all = iou_gt.argmax(axis=1) if gt_faces else None
            for pi in order:
                conf = float(pred_boxes[pi, 4])
                if gt_faces:
                    best_idx = int(best_idx_all[pi])
                    best_iou = float(iou_gt[pi, best_idx])
                else:
                    best_iou, best_idx = 0.0, -1
                if best_iou >= self.iou_threshold and best_iou > 0.0 and not gt_matched[best_idx]:
                    gt_matched[best_idx] = True
                    is_tp, is_ignored = True, False
                else:
                    is_tp = False
                    is_ignored = bool(hits_ignored[pi])
                if not is_ignored:
                    all_detections.append({"confidence": conf, "is_tp": is_tp})
            false_negatives += sum(1 for m in gt_matched if not m)

        ap = average_precision_11pt(all_detections, total_gt)
        filtered = [d for d in all_detections if d["confidence"] >= self.global_confidence]
        tp = sum(1 for d in filtered if d["is_tp"])
        fp = len(filtered) - tp
        precision = tp / len(filtered) if filtered else 0.0
        recall = tp / total_gt if total_gt else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        return {
            "category": set_name,
            "total_gt": total_gt,
            "total_pred": len(filtered),
            "true_positives": tp,
            "false_positives": fp,
            "false_negatives": false_negatives,
            "precision": precision,
            "recall": recall,
            "f1_score": f1,
            "ap": ap,
        }

    def run(self, save: bool = True) -> dict:
        """Both evaluation parts (eval/eval_dual.py:435-608)."""
        t0 = time.time()
        subcategory_results = [
            self.evaluate_single_set(c, [c]) for c in self.subcategories
        ]
        difficulty_results = [
            self.evaluate_single_set(d, DIFFICULTY_MAPPING[d])
            for d in self.difficulties
        ]
        results = {
            "mode": self.mode_string,
            "subcategory_results": subcategory_results,
            "difficulty_results": difficulty_results,
            "elapsed_seconds": time.time() - t0,
            "num_images": len(self.subcategory_gt),
        }
        if save:
            os.makedirs(self.output_dir, exist_ok=True)
            with open(os.path.join(self.output_dir, "dual_eval_results.json"), "w") as f:
                json.dump(results, f, indent=2)
            self._plot(results)
        return results

    def _plot(self, results: dict) -> Optional[str]:
        """3-panel AP/precision/recall bar chart (eval/eval_dual.py:610-682)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        rows = results["subcategory_results"] + results["difficulty_results"]
        names = [r["category"] for r in rows]
        fig, axes = plt.subplots(1, 3, figsize=(16, 5))
        for ax, key in zip(axes, ("ap", "precision", "recall")):
            ax.bar(range(len(rows)), [r[key] for r in rows], color="#4c72b0")
            ax.set_xticks(range(len(rows)))
            ax.set_xticklabels(names, rotation=45, ha="right", fontsize=8)
            ax.set_title(key.upper())
            ax.set_ylim(0, 1)
            ax.grid(axis="y", alpha=0.3)
        fig.suptitle(f"Dual evaluation — {self.mode_string}")
        fig.tight_layout()
        path = os.path.join(self.output_dir, "dual_eval_chart.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
