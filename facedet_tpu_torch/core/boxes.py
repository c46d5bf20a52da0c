"""Box geometry over ``[..., 4]`` xyxy float tensors.

Counterpart of facedet_tpu/core/boxes.py: every function of it, with the
same formulas and the same ``eps``. A scalar argument (a shift, a scale)
may be a number or a tensor; it is taken in the boxes' dtype and device.
"""
from __future__ import annotations

import torch

__all__ = [
    "xyxy_to_xywh",
    "xywh_to_xyxy",
    "xyxy_to_cxcywh",
    "cxcywh_to_xyxy",
    "box_area",
    "intersection_matrix",
    "iou_matrix",
    "ios_matrix",
    "pair_metric_matrix",
    "clip_boxes",
    "shift_boxes",
    "scale_boxes",
    "union_boxes",
]


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """[x1,y1,x2,y2] -> [x,y,w,h] (top-left + size, COCO convention)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], dim=-1)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; negative extents clamp to zero."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def intersection_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection areas: a [..., N, 4], b [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def iou_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    inter = intersection_matrix(a, b)
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / union.clamp(min=eps)


def ios_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Pairwise intersection over the smaller area (SAHI's IOS metric)."""
    inter = intersection_matrix(a, b)
    smaller = torch.minimum(box_area(a)[..., :, None], box_area(b)[..., None, :])
    return inter / smaller.clamp(min=eps)


def pair_metric_matrix(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    """Dispatch on the SAHI match metric name ('IOU' | 'IOS')."""
    metric = metric.upper()
    if metric == "IOU":
        return iou_matrix(a, b)
    if metric == "IOS":
        return ios_matrix(a, b)
    raise ValueError(f"unknown match metric: {metric!r} (expected IOU or IOS)")


def clip_boxes(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """Clamp xyxy boxes into [0,width]x[0,height]."""
    x1 = boxes[..., 0].clamp(0, width)
    y1 = boxes[..., 1].clamp(0, height)
    x2 = boxes[..., 2].clamp(0, width)
    y2 = boxes[..., 3].clamp(0, height)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def _like(v, boxes: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=boxes.dtype, device=boxes.device)


def shift_boxes(boxes: torch.Tensor, shift_x, shift_y) -> torch.Tensor:
    """Slice-local -> global coordinates: ``shift_x`` / ``shift_y`` (numbers,
    or tensors broadcasting against ``boxes[..., 0]``) added to x and y."""
    sx, sy = _like(shift_x, boxes), _like(shift_y, boxes)
    sx, sy = torch.broadcast_tensors(sx, sy)
    return boxes + torch.stack([sx, sy, sx, sy], dim=-1)


def scale_boxes(boxes: torch.Tensor, scale) -> torch.Tensor:
    """``boxes * scale``, the mapping of the enhance-first pipelines."""
    return boxes * _like(scale, boxes)


def union_boxes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Smallest box covering both: SAHI's NMM merge of a matched pair."""
    return torch.cat([torch.minimum(a[..., :2], b[..., :2]), torch.maximum(a[..., 2:], b[..., 2:])], dim=-1)
