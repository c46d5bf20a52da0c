"""Box geometry over ``[..., 4]`` xyxy float tensors.

Counterpart of facedet_tpu/core/boxes.py (the subset the sliced-prediction
path uses), with the same formulas and the same ``eps``.
"""
from __future__ import annotations

import torch

__all__ = [
    "box_area",
    "intersection_matrix",
    "iou_matrix",
    "ios_matrix",
    "pair_metric_matrix",
    "clip_boxes",
]


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
