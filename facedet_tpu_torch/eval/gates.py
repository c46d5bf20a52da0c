"""The detection gates that hold one run of the detector against another.

Both take detections as dicts of numpy arrays, ``boxes`` [N,4] xyxy and
``scores`` [N] (``kpts`` [N,K,3] optional), in the order of the results, as
``Detections.to_numpy()`` gives them.

- ``section2_gate``: PERF.md §2's float gates, row by row: equal counts,
  boxes within 0.05 px, scores within 1e-3, keypoints (where both sides
  have them) within 0.1 px.
- ``int8_gate``: the int8 detector's gate. The int8 function is
  discontinuous (a float within an ulp of a half level rounds either way,
  and one level moved early moves later inputs by a whole step), so two
  float paths of it are held to equal counts and each reference detection
  matched one to one (best IoU, in score order) at IoU >= 0.85 and a score
  within 0.05. In bfloat16 the float layers around the int8 ones differ
  between two paths by a bfloat16 ulp per layer, and the gate takes a
  score bound and a floor under which a detection may go unmatched.
"""
from __future__ import annotations

import numpy as np

__all__ = ["BOX_ATOL", "SCORE_ATOL", "KPT_ATOL", "section2_gate", "int8_gate"]

BOX_ATOL, SCORE_ATOL, KPT_ATOL = 0.05, 1e-3, 0.1
INT8_MIN_IOU, INT8_MAX_DSCORE = 0.85, 0.05


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


def section2_gate(got: dict, want: dict) -> tuple[bool, dict]:
    """(passed, the largest errors) of ``got`` against ``want``."""
    if got["boxes"].shape != want["boxes"].shape:
        return False, {"counts": (len(got["boxes"]), len(want["boxes"]))}
    if not len(want["boxes"]):
        return True, {}
    err = {"boxes": float(np.abs(got["boxes"] - want["boxes"]).max()),
           "scores": float(np.abs(got["scores"] - want["scores"]).max())}
    held = err["boxes"] <= BOX_ATOL and err["scores"] <= SCORE_ATOL
    if "kpts" in got and "kpts" in want:
        err["kpts"] = float(np.abs(got["kpts"][..., :2] - want["kpts"][..., :2]).max())
        held = held and err["kpts"] <= KPT_ATOL
    return held, err


def int8_gate(got: dict, want: dict, max_dscore: float = INT8_MAX_DSCORE,
              free_below: float = 0.0) -> tuple[bool, float, float]:
    """(passed, worst IoU, worst |dscore|) of ``got`` against ``want``:
    each detection of ``want``, in score order, matched to the unused one of
    ``got`` it overlaps most, at IoU >= 0.85 and a score within
    ``max_dscore``; no detection of ``got`` left over. A detection that
    scores below ``free_below`` may go unmatched on either side (one near
    the confidence threshold crosses it under a small change)."""
    (gb, gs), (wb, ws) = (got["boxes"], got["scores"]), (want["boxes"], want["scores"])
    iou = _iou(wb, gb) if len(wb) and len(gb) else np.zeros((len(wb), len(gb)))
    worst_iou, worst_ds, used = 1.0, 0.0, set()
    for i in np.argsort(-ws):
        free = [j for j in range(len(gb)) if j not in used]
        j = max(free, key=lambda j: iou[i, j], default=None)  # noqa: B023
        if j is None or iou[i, j] < INT8_MIN_IOU:
            if ws[i] >= free_below:
                worst_iou = 0.0 if j is None else min(worst_iou, float(iou[i, j]))
            continue
        used.add(j)
        worst_iou, worst_ds = min(worst_iou, float(iou[i, j])), max(worst_ds, float(abs(gs[j] - ws[i])))
    if any(gs[j] >= free_below for j in range(len(gb)) if j not in used):
        worst_iou = 0.0
    return worst_iou >= INT8_MIN_IOU and worst_ds <= max_dscore, worst_iou, worst_ds
