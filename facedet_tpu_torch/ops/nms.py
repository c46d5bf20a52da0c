"""Greedy NMS / NMM / GreedyNMM merge over fixed-capacity detections.

Counterpart of facedet_tpu/ops/nms.py, with the same algorithm: greedy NMS
("keep i iff no kept j with a higher score matches i") is the fixpoint of a
dominance recursion, solved by Jacobi iteration, one masked matvec per round.
JAX runs the rounds in a ``lax.while_loop``; here a Python loop reads the
"changed" flag back to the host once per round. NMM box merging (union box
per keeper, the keeper's score, class and keypoints kept) is then one masked
min/max reduction.

Every function takes an optional leading batch axis (``[B, N, ...]``), which
runs B independent merges; the loop ends when all of them have converged.
"""
from __future__ import annotations

import torch

from facedet_tpu_torch.core.boxes import pair_metric_matrix
from facedet_tpu_torch.core.detections import Detections

__all__ = ["merge_detections", "nms", "greedy_keep_mask", "POSTPROCESS_TYPES"]

POSTPROCESS_TYPES = ("NMS", "NMM", "GREEDYNMM", "LSNMS")
# LSNMS is a CPU locality optimisation with NMS semantics: an alias here.
_MODE_ALIASES = {"LSNMS": "NMS"}


def greedy_keep_mask(match: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact greedy-NMS keep mask by fixpoint iteration.

    match: [..., N, N] bool, True where row i (higher score) suppresses
    column j. valid: [..., N] bool. Returns kept [..., N] bool."""
    matchf_t = match.to(torch.float32).transpose(-1, -2)
    kept = valid
    while True:
        suppressed = torch.matmul(matchf_t, kept.to(torch.float32)[..., None])[..., 0] > 0.0
        new_kept = valid & ~suppressed
        changed = bool((new_kept != kept).any())
        kept = new_kept
        if not changed:
            return kept


def merge_detections(
    det: Detections,
    mode: str = "GREEDYNMM",
    match_metric: str = "IOS",
    match_threshold: float = 0.5,
    class_agnostic: bool = True,
) -> Detections:
    """Greedy merge over a fixed-capacity ``Detections``. Returns detections
    sorted by descending score with suppressed rows masked invalid."""
    mode = mode.upper()
    if mode not in POSTPROCESS_TYPES:
        raise ValueError(f"unknown postprocess {mode!r}; expected {POSTPROCESS_TYPES}")
    mode = _MODE_ALIASES.get(mode, mode)
    merge_boxes = mode in ("NMM", "GREEDYNMM")

    det = det.sort_by_score()
    n = det.capacity
    device = det.scores.device
    match = pair_metric_matrix(det.boxes, det.boxes, match_metric) > match_threshold
    if not class_agnostic:
        match &= det.classes[..., :, None] == det.classes[..., None, :]
    # only lower-scored (later) rows can be suppressed/merged into row i
    idx = torch.arange(n, device=device)
    tri = idx[None, :] > idx[:, None]
    match &= tri & det.valid[..., None, :] & det.valid[..., :, None]

    kept = greedy_keep_mask(match, det.valid)
    boxes = det.boxes

    if merge_boxes:
        # member[i, j]: suppressed box j belongs to keeper i's group — the
        # first (highest-score) kept row matching it, per greedy semantics.
        cand = match & kept[..., :, None] & ~kept[..., None, :]
        first_keeper = torch.where(cand, idx[:, None], n).amin(dim=-2)
        member = (first_keeper[..., None, :] == idx[:, None]) & cand
        group = member | (torch.eye(n, dtype=torch.bool, device=device) & kept[..., :, None])
        g = group[..., None]
        inf = torch.tensor(torch.inf, dtype=boxes.dtype, device=device)
        gx1y1 = torch.where(g, boxes[..., None, :, :2], inf).amin(dim=-2)
        gx2y2 = torch.where(g, boxes[..., None, :, 2:], -inf).amax(dim=-2)
        merged = torch.cat([gx1y1, gx2y2], dim=-1)
        boxes = torch.where(kept[..., None], merged, boxes)

    return Detections(
        boxes=boxes,
        scores=det.scores,
        classes=det.classes,
        kpts=det.kpts,
        valid=kept,
    )


def nms(det: Detections, iou_threshold: float = 0.7, class_agnostic: bool = True) -> Detections:
    """Plain IoU NMS (the per-tile in-model NMS)."""
    return merge_detections(
        det,
        mode="NMS",
        match_metric="IOU",
        match_threshold=iou_threshold,
        class_agnostic=class_agnostic,
    )
