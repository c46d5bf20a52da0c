"""COCO-style mAP scorer (mAP@[.5:.95], mAP@.5, mAP@.75).

Self-contained replacement for the pycocotools ``COCOeval`` dependency the
reference tuner drives (utils/tuning_sahi.py:10-11,142-158): greedy
highest-IoU matching per score-sorted prediction at each IoU threshold, and
101-point interpolated AP — the COCO protocol for a single category with
area=all, maxDets=100.

A copy of facedet_tpu/eval/coco_map.py (host float64 numpy).
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)

__all__ = ["coco_map", "ap_at_iou"]


def _iou_matrix_xywh(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    p = pred.astype(float).copy()
    g = gt.astype(float).copy()
    p[:, 2:] += p[:, :2]
    g[:, 2:] += g[:, :2]
    iw = np.clip(
        np.minimum(p[:, None, 2], g[None, :, 2]) - np.maximum(p[:, None, 0], g[None, :, 0]),
        0,
        None,
    )
    ih = np.clip(
        np.minimum(p[:, None, 3], g[None, :, 3]) - np.maximum(p[:, None, 1], g[None, :, 1]),
        0,
        None,
    )
    inter = iw * ih
    area_p = (p[:, 2] - p[:, 0]) * (p[:, 3] - p[:, 1])
    area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    union = area_p[:, None] + area_g[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def ap_at_iou(
    preds_by_image: dict, gts_by_image: dict, iou_threshold: float, max_dets: int = 100
) -> float:
    """AP for one IoU threshold; preds [P,5] xywh+score, gts [G,4] xywh."""
    records = []  # (score, is_tp)
    total_gt = 0
    for img_id, gt in gts_by_image.items():
        gt = np.asarray(gt, float).reshape(-1, 4)
        total_gt += gt.shape[0]
        pred = np.asarray(preds_by_image.get(img_id, np.zeros((0, 5))), float).reshape(-1, 5)
        order = np.argsort(-pred[:, 4], kind="stable")[:max_dets]
        pred = pred[order]
        if pred.shape[0] == 0:
            continue
        if gt.shape[0] == 0:
            records.extend((s, False) for s in pred[:, 4])
            continue
        ious = _iou_matrix_xywh(pred[:, :4], gt)
        taken = np.zeros(gt.shape[0], bool)
        for i in range(pred.shape[0]):
            cand = np.where(~taken, ious[i], -1.0)
            j = int(cand.argmax())
            if cand[j] >= iou_threshold:
                taken[j] = True
                records.append((pred[i, 4], True))
            else:
                records.append((pred[i, 4], False))
    if total_gt == 0 or not records:
        return 0.0
    records.sort(key=lambda r: -r[0])
    tps = np.array([r[1] for r in records], float)
    tp_cum = np.cumsum(tps)
    fp_cum = np.cumsum(1.0 - tps)
    recall = tp_cum / total_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    # precision envelope + 101-point interpolation (COCO protocol)
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    interp = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(interp.mean())


def coco_map(
    predictions: list[dict], ground_truths: list[dict], max_dets: int = 100
) -> dict:
    """COCO-format prediction/annotation dicts -> mAP metrics.

    predictions: {image_id, bbox [x,y,w,h], score}; ground_truths:
    {image_id, bbox}. Returns {"map": .., "map50": .., "map75": ..}."""
    preds_by_image: dict = defaultdict(list)
    gts_by_image: dict = defaultdict(list)
    for p in predictions:
        preds_by_image[p["image_id"]].append([*p["bbox"], p["score"]])
    for g in ground_truths:
        gts_by_image[g["image_id"]].append(list(g["bbox"]))
    # every image with GT participates, even without predictions
    preds_by_image = {k: np.asarray(v, float) for k, v in preds_by_image.items()}
    gts_by_image = {k: np.asarray(v, float) for k, v in gts_by_image.items()}
    aps = {
        t: ap_at_iou(preds_by_image, gts_by_image, t, max_dets) for t in IOU_THRESHOLDS
    }
    return {
        "map": float(np.mean(list(aps.values()))),
        "map50": aps[0.5],
        "map75": aps[0.75],
        "per_iou": {f"{t:.2f}": v for t, v in aps.items()},
    }
