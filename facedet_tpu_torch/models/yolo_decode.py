"""YOLOv11 head decode: DFL expectation, anchor grids, keypoint decode, and
fixed-capacity top-k + per-tile NMS into ``Detections``.

Counterpart of facedet_tpu/models/yolo_decode.py. ``lax.top_k`` breaks ties
toward the lower index; ``torch.topk`` promises no order, so the top-k here
is a stable descending sort cut to k.
"""
from __future__ import annotations

import torch

from facedet_tpu_torch.core.detections import Detections, take_rows
from facedet_tpu_torch.models.yolov11 import REG_MAX, STRIDES
from facedet_tpu_torch.ops.nms import merge_detections

__all__ = ["decode_predictions", "decode_to_detections"]


def _level_anchors(h: int, w: int, device) -> torch.Tensor:
    """Anchor cell centres (x, y) in cell units, [h*w, 2]."""
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def decode_predictions(level_outputs: list[dict]) -> dict:
    """Per-level NHWC raw maps -> flat per-anchor predictions.

    Returns a dict with boxes [B, A, 4] xyxy in input pixels, scores
    [B, A, C] sigmoid class probabilities, and kpts [B, A, K, 3] decoded
    keypoints (when the head has a pose branch)."""
    boxes, scores, kpts = [], [], []
    device = level_outputs[0]["box"].device
    proj = torch.arange(REG_MAX, dtype=torch.float32, device=device)
    for level, stride in zip(level_outputs, STRIDES):
        box_map = level["box"]
        b, h, w, _ = box_map.shape
        anchors = _level_anchors(h, w, device)
        s = float(stride)

        dist = box_map.reshape(b, h * w, 4, REG_MAX)
        dist = (torch.softmax(dist, dim=-1) * proj).sum(-1)  # [B,A,4] ltrb
        x1y1 = (anchors[None] - dist[..., :2]) * s
        x2y2 = (anchors[None] + dist[..., 2:]) * s
        boxes.append(torch.cat([x1y1, x2y2], dim=-1))

        scores.append(torch.sigmoid(level["cls"].reshape(b, h * w, -1)))

        if "kpt" in level:
            km = level["kpt"].reshape(b, h * w, -1, 3)
            axy = anchors[None, :, None, :]
            kxy = (km[..., :2] * 2.0 + (axy - 0.5)) * s
            kv = torch.sigmoid(km[..., 2:3])
            kpts.append(torch.cat([kxy, kv], dim=-1))

    out = {"boxes": torch.cat(boxes, dim=1), "scores": torch.cat(scores, dim=1)}
    if kpts:
        out["kpts"] = torch.cat(kpts, dim=1)
    return out


def decode_to_detections(
    preds: dict,
    conf_threshold: float = 0.25,
    max_detections: int = 300,
    nms_iou: float = 0.7,
    class_agnostic: bool = True,
    with_nms: bool = True,
) -> Detections:
    """Flat per-anchor predictions -> per-image ``Detections`` [B, k]:
    confidence filter, top-k pre-select, class = argmax, IoU NMS."""
    boxes, scores = preds["boxes"], preds["scores"]
    b, a, _ = scores.shape
    best, cls = scores.max(dim=-1)
    valid = best >= conf_threshold

    k = min(max_detections, a)
    key = torch.where(valid, best, torch.full_like(best, -1.0))
    top_val, top_idx = torch.sort(key, dim=1, descending=True, stable=True)
    top_val, top_idx = top_val[:, :k], top_idx[:, :k]

    if "kpts" in preds:
        sel_kpts = take_rows(preds["kpts"], top_idx)
    else:
        sel_kpts = torch.zeros((b, k, 5, 3), dtype=torch.float32, device=boxes.device)
    det = Detections(
        boxes=take_rows(boxes, top_idx),
        scores=top_val.clamp(min=0.0),
        classes=take_rows(cls, top_idx).to(torch.int32),
        kpts=sel_kpts,
        valid=top_val >= conf_threshold,
    )
    if with_nms:
        det = merge_detections(
            det, mode="NMS", match_metric="IOU", match_threshold=nms_iou, class_agnostic=class_agnostic
        )
    return det
