"""Plain float32 sliced detection (SAHI): slice grid, tile crop, the
family's per-tile detection, letterboxed standard pass, shift to image
coordinates, greedy merge, clip. Each step is written out the
straightforward way (loops over kept boxes, slicing for the tiles); nothing
of the program is imported.

Semantics, as the program documents them:
  * grid: SAHI ``get_slice_bboxes`` (stride S - int(overlap * S), edge tiles
    moved inward to exactly S), tile counts bucketed to {1, 2, 4, 6, 8, 12,
    16, 24, 32, 48, 64, 96, 128}, padding tiles repeat offset 0 and are
    invalid; the canvas is the image zero-padded to multiples of 256;
  * per tile: the detector family's own function
    (``families/<family>.py``'s ``reference``); ``tile_detections`` is the
    post-processing of a family with NMS: class score >= conf, the 300 best
    by a stable descending sort, greedy IoU-0.7 NMS;
  * standard pass: the padded canvas resampled (``jax.image.
    scale_and_translate``, antialiased triangle, translation 0) at the scale
    min(S/h, S/w) into an S x S image, boxes divided by the scale;
  * merge: all detections sorted by score (stable), cut to 1024, greedy
    matching by IOS > 0.5 over the original boxes, each kept box replaced by
    the union of its group (the suppressed boxes whose first matching kept
    box it is), score, class and keypoints of the kept one;
  * clip to the image, zero-area boxes dropped; with a fetch capacity, the
    best ``fetch`` rows only.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BUCKETS = (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def _starts(size: int, s: int, step: int) -> list[int]:
    out, pos = [], 0
    while pos + s < size:
        out.append(pos)
        pos += step
    out.append(max(0, size - s))
    return sorted(set(out))


def slice_grid(h: int, w: int, sh: int, sw: int, overlap: float = 0.2):
    """(offsets [T, 2] (y, x) int, T_bucket, canvas (H, W))."""
    ys = _starts(h, sh, max(sh - int(overlap * sh), 1))
    xs = _starts(w, sw, max(sw - int(overlap * sw), 1))
    offsets = np.array([(y, x) for y in ys for x in xs], np.int64).reshape(-1, 2)
    t = len(offsets)
    bucket = next((b for b in BUCKETS if t <= b), 2 ** math.ceil(math.log2(t)))
    canvas = tuple(max(256, -(-max(d, s) // 256) * 256) for d, s in ((h, sh), (w, sw)))
    return offsets, bucket, canvas


def fixed_grid_slices(h: int, w: int) -> tuple[int, int]:
    """The enhance-first pipeline's slice size: a 3 x 3 grid (4 x 4 past
    3000 px), each side rounded up to a multiple of 64."""
    n = 3 if max(h, w) < 3000 else 4
    return math.ceil(h / n / 64) * 64, math.ceil(w / n / 64) * 64


def resample_weights(n_in: int, n_out: int, scale: torch.Tensor) -> torch.Tensor:
    """[n_in, n_out] antialiased triangle weights of ``jax.image.
    scale_and_translate`` at float32 ``scale``, translation 0."""
    inv = 1.0 / scale
    kscale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kscale
    wts = (1.0 - x).clamp(min=0.0)
    total = wts.sum(0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps), wts / total, torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros_like(wts))


def _area(b: np.ndarray) -> np.ndarray:
    return np.clip(b[..., 2] - b[..., 0], 0, None) * np.clip(b[..., 3] - b[..., 1], 0, None)


def _inter(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    return wh[..., 0] * wh[..., 1]


def match_matrix(boxes: np.ndarray, metric: str) -> np.ndarray:
    inter = _inter(boxes, boxes)
    area = _area(boxes)
    if metric == "IOU":
        den = area[:, None] + area[None, :] - inter
    else:  # IOS: intersection over the smaller box
        den = np.minimum(area[:, None], area[None, :])
    return inter / np.maximum(den, 1e-9)


def greedy(boxes: np.ndarray, order_scores: np.ndarray, metric: str, threshold: float, merge: bool):
    """Greedy NMS (``merge=False``) or NMM over rows already sorted by
    descending score: (kept row indices, their boxes)."""
    n = len(boxes)
    m = match_matrix(boxes, metric) > threshold if n else np.zeros((0, 0), bool)
    suppressed = np.zeros(n, bool)
    kept, out = [], []
    for i in range(n):
        if suppressed[i]:
            continue
        group = [j for j in range(i + 1, n) if not suppressed[j] and m[i, j]]
        suppressed[group] = True
        kept.append(i)
        if merge and group:
            g = boxes[[i] + group]
            out.append(np.concatenate([g[:, :2].min(0), g[:, 2:].max(0)]))
        else:
            out.append(boxes[i])
    return np.array(kept, np.int64), np.array(out, np.float32).reshape(-1, 4)


def stable_desc(scores: np.ndarray) -> np.ndarray:
    return np.argsort(-scores, kind="stable")


def tile_detections(model, decode, tiles: torch.Tensor, conf: float, top_k: int = 300) -> list[dict]:
    """Per tile: the decoded detections after the confidence filter, the
    top-k and IoU-0.7 NMS, as numpy {boxes, scores, kpts} in tile pixels."""
    preds = decode(model(tiles))
    out = []
    for b in range(tiles.shape[0]):
        scores = preds["scores"][b].cpu().numpy()
        order = stable_desc(np.where(scores >= conf, scores, -1.0))[:top_k]
        order = order[scores[order] >= conf]
        boxes = preds["boxes"][b].cpu().numpy()[order]
        kpts = preds["kpts"][b].cpu().numpy()[order]
        kept, _ = greedy(boxes, scores[order], "IOU", 0.7, merge=False)
        out.append({"boxes": boxes[kept], "scores": scores[order][kept], "kpts": kpts[kept]})
    return out


def sliced_detect(detect_tiles, canvas: torch.Tensor, h: int, w: int, sh: int, sw: int, *, conf: float,
                  img_size: int = 640, overlap: float = 0.2, match_threshold: float = 0.5,
                  merge_capacity: int = 1024, fetch: int = 0, tile_batch: int = 8) -> dict:
    """The sliced pipeline on a float32 CHW ``canvas`` [3, Hc, Wc] in [0, 1]
    (the image at the top left, zeros elsewhere) of an ``h`` x ``w`` image,
    with ``detect_tiles(tiles [B, 3, h, w], conf)`` -> per tile numpy
    {boxes, scores, kpts} in tile pixels. Returns numpy {boxes, scores,
    kpts} of the merged detections, by descending score."""
    offsets, _bucket, _ = slice_grid(h, w, sh, sw, overlap)
    parts = []
    for i in range(0, len(offsets), tile_batch):
        chunk = offsets[i:i + tile_batch]
        tiles = torch.stack([canvas[:, y:y + sh, x:x + sw] for y, x in chunk])
        for (y, x), det in zip(chunk, detect_tiles(tiles, conf)):
            shift = np.array([x, y], np.float32)
            det["boxes"] = det["boxes"] + np.tile(shift, 2)
            det["kpts"][..., :2] += shift
            parts.append(det)
    scale = torch.minimum(torch.tensor(img_size / h, dtype=torch.float32), torch.tensor(img_size / w, dtype=torch.float32))
    wh = resample_weights(canvas.shape[1], img_size, scale).to(canvas.device)
    ww = resample_weights(canvas.shape[2], img_size, scale).to(canvas.device)
    full = torch.matmul(torch.matmul(wh.t(), canvas), ww)
    std = detect_tiles(full[None], conf)[0]
    s = float(scale)
    std["boxes"] = std["boxes"] / np.float32(s)
    std["kpts"][..., :2] /= np.float32(s)
    parts.append(std)
    boxes = np.concatenate([p["boxes"] for p in parts])
    scores = np.concatenate([p["scores"] for p in parts])
    kpts = np.concatenate([p["kpts"] for p in parts])
    order = stable_desc(scores)[:merge_capacity]
    boxes, scores, kpts = boxes[order], scores[order], kpts[order]
    kept, merged = greedy(boxes, scores, "IOS", match_threshold, merge=True)
    scores, kpts = scores[kept], kpts[kept]
    merged[:, 0::2] = np.clip(merged[:, 0::2], 0, w)
    merged[:, 1::2] = np.clip(merged[:, 1::2], 0, h)
    alive = (merged[:, 2] > merged[:, 0]) & (merged[:, 3] > merged[:, 1])
    out = {"boxes": merged[alive], "scores": scores[alive], "kpts": kpts[alive]}
    if fetch:
        out = {k: v[:fetch] for k, v in out.items()}
    return out
