"""SCRFD training: task-aligned assignment with IoU, BCE and keypoint losses.

Counterpart of facedet_tpu/train/scrfd_train.py. The assigner is YOLO's
``tal_assign`` (train/yolo_train.py), with SCRFD's head conventions: ltrb
distances in stride units from anchor centres without the half-cell offset
(models/scrfd.decode_scrfd), two anchors per location in anchor-fastest
order, a sigmoid score, keypoint offsets from the centres. The train step
and the staged loop are YOLO's with ``scrfd_loss`` put in.
"""
from __future__ import annotations

from typing import Optional

import torch

from facedet_tpu_torch.models.scrfd import NUM_ANCHORS, STRIDES
from facedet_tpu_torch.train.yolo_train import (
    _bce,
    _iou_xyxy,
    _take_rows,
    make_staged_train_loop,
    make_train_step,
    tal_assign,
)

__all__ = ["scrfd_loss", "make_scrfd_train_step", "make_scrfd_staged_loop"]


def _flat_centers(level_shapes: list[tuple[int, int]], device=None):
    """Anchor centres [A, 2] (px) and per-anchor stride [A], anchor-fastest
    as ``decode_scrfd`` reshapes."""
    centers, strides = [], []
    for (h, w), s in zip(level_shapes, STRIDES):
        ys = torch.arange(h, dtype=torch.float32, device=device) * s
        xs = torch.arange(w, dtype=torch.float32, device=device) * s
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        c = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)
        centers.append(c.repeat_interleave(NUM_ANCHORS, dim=0))
        strides.append(torch.full((h * w * NUM_ANCHORS,), float(s), device=device))
    return torch.cat(centers), torch.cat(strides)


def scrfd_loss(
    level_outputs: list[dict],
    gt_boxes: torch.Tensor,  # [B, M, 4] xyxy px
    gt_mask: torch.Tensor,  # [B, M] bool
    gt_kpts: Optional[torch.Tensor] = None,  # [B, M, K, 3]
    box_weight: float = 2.0,
    cls_weight: float = 1.0,
    kps_weight: float = 0.1,
) -> tuple[torch.Tensor, dict]:
    """Raw NHWC level maps (``Scrfd.forward``) and padded GT -> (total,
    parts {box, cls[, kps]}), each part the batch mean of its per-image
    value."""
    level_shapes = [(lvl["cls"].shape[1], lvl["cls"].shape[2]) for lvl in level_outputs]
    centers, strides = _flat_centers(level_shapes, level_outputs[0]["cls"].device)
    b = level_outputs[0]["cls"].shape[0]
    cls_lg = torch.cat([lvl["cls"].reshape(b, -1, 1) for lvl in level_outputs], 1)
    dist = torch.cat([lvl["box"].reshape(b, -1, 4) * s for lvl, s in zip(level_outputs, STRIDES)], 1)
    mask = gt_mask.bool()

    pred_boxes = torch.cat([centers - dist[..., :2], centers + dist[..., 2:]], -1)  # [B, A, 4]
    pred_scores = torch.sigmoid(cls_lg)
    fg, best_gt, norm_align = tal_assign(centers, pred_boxes.detach(), pred_scores.detach(), gt_boxes, mask)
    tgt_boxes = _take_rows(gt_boxes, best_gt)
    wsum = torch.clamp(norm_align.sum(-1), min=1.0)
    iou = _iou_xyxy(pred_boxes, tgt_boxes)
    losses = {
        "box": torch.where(fg, (1.0 - iou) * norm_align, 0.0).sum(-1) / wsum,
        "cls": _bce(cls_lg, torch.where(fg, norm_align, 0.0)[..., None]).sum((-1, -2)) / wsum,
    }
    has_kpt = gt_kpts is not None and "kps" in level_outputs[0]
    if has_kpt:
        k = gt_kpts.shape[-2]
        kps = torch.cat([lvl["kps"].reshape(b, -1, k, 2) * s for lvl, s in zip(level_outputs, STRIDES)], 1)
        tgt_kp = _take_rows(gt_kpts, best_gt)  # [B, A, K, 3]
        pred_xy = centers[:, None, :] + kps  # [B, A, K, 2]
        vis = (tgt_kp[..., 2] > 0) & fg[..., None]
        kw = torch.clamp(vis.sum((-1, -2)), min=1)
        # SCRFD normalises keypoint regression by the anchor stride
        l1 = (pred_xy - tgt_kp[..., :2]).abs().sum(-1) / strides[:, None]
        losses["kps"] = (l1 * vis).sum((-1, -2)) / kw
    losses = {k: v.mean() for k, v in losses.items()}
    total = box_weight * losses["box"] + cls_weight * losses["cls"]
    if has_kpt:
        total = total + kps_weight * losses["kps"]
    return total, losses


def make_scrfd_train_step(model, tx):
    """``step(images [B,H,W,3] in [0,1], gt_boxes, gt_mask, gt_kpts | None)
    -> (loss, parts)``; ``gt_kpts=None`` trains box and score only."""
    return make_train_step(model, tx, loss=scrfd_loss)


def make_scrfd_staged_loop(model, tx, steps_per_dispatch: int = 100, flip: bool = True, seed: int = 0):
    """YOLO's staged loop (``make_staged_train_loop``) with ``scrfd_loss``:
    the same ``run(images_u8, gt_boxes, gt_mask, gt_kpts, start, flips)``."""
    return make_staged_train_loop(model, tx, steps_per_dispatch, flip, loss=scrfd_loss, seed=seed)
