"""Recover 5-landmark keypoints for the golden faces from the reference's
committed rendered detail images.

The reference's Streamlit pipeline saves a ``*_detail.jpg`` per image with
each detected face's keypoints drawn as fixed per-landmark colors
(reference utils/visualization.py:26-35: BGR blue/green/red/cyan/magenta
for left-eye/right-eye/nose/left-mouth/right-mouth, radius-2 filled circles
with a white border, drawn only when kpt confidence > 0.3). Those drawings are
the only committed record of the reference model's landmark output — this tool
color-matches the dots inside each recovered golden bbox and emits approximate
keypoint ground truth (+-2-3 px: dot radius + JPEG bleed).

Output (default runs/golden_keypoints/golden_keypoints.json):
  {"images": {<goldens key>: {"faces": [{"face_index": i, "bbox": [...],
   "kpts": [[x, y, v] * 5]}]}}}   (v=1 recovered, v=0 not drawn/found)

Run: python -m facedet_tpu_torch.tools.golden_keypoints \
    --goldens facedet_tpu/eval/assets/reference_goldens.json \
    --ref-dir reference [--out runs/golden_keypoints/golden_keypoints.json]

Counterpart of facedet_tpu/tools/golden_keypoints.py, copied (host numpy).
It reads the committed goldens by default and writes under ``runs/``, never
into the JAX package's assets.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from facedet_tpu_torch.tools.golden_finetune import GOLDENS_PATH, REF_DIR

# keypoint draw colors in RGB as read back from the BGR-written JPEG
# (reference utils/visualization.py:26-35)
KEYPOINT_COLORS_RGB = [
    (0, 0, 255),    # left_eye   (BGR blue)
    (0, 255, 0),    # right_eye  (green)
    (255, 0, 0),    # nose       (BGR red)
    (0, 255, 255),  # left_mouth (BGR cyan)
    (255, 0, 255),  # right_mouth(magenta)
]

__all__ = ["KEYPOINT_COLORS_RGB", "recover_face_keypoints", "recover_all", "main"]


def _find_detail_image(ref_dir: str, key: str):
    d = os.path.join(ref_dir, key)
    hits = glob.glob(os.path.join(d, "*_detail.jpg"))
    return hits[0] if hits else None


def recover_face_keypoints(
    detail: np.ndarray,
    bbox,
    pad: int = 10,
    border_exclude: int = 4,
    max_dist: int = 170,
    min_px: int = 3,
) -> np.ndarray:
    """Color-match the 5 keypoint dots inside ``bbox`` (+pad) of a rendered
    detail image. Excludes a strip around the bbox border (the reference draws
    the box itself in pure green there, which would alias right_eye).

    Returns [5, 3] float32 (x, y, v) in image coords, v=0 when not found."""
    h, w = detail.shape[:2]
    x1, y1, x2, y2 = [int(v) for v in bbox]
    ox, oy = max(0, x1 - pad), max(0, y1 - pad)
    sub = detail[oy : min(h, y2 + pad), ox : min(w, x2 + pad)].astype(np.int32)
    out = np.zeros((5, 3), np.float32)
    if sub.size == 0:
        return out
    sh, sw = sub.shape[:2]
    # exclude the bbox outline strip (and the conf label above it): pixels
    # within border_exclude of the box rectangle's edges
    yy, xx = np.mgrid[0:sh, 0:sw]
    gx, gy = xx + ox, yy + oy
    near_v = (np.abs(gx - x1) <= border_exclude) | (np.abs(gx - x2) <= border_exclude)
    near_h = (np.abs(gy - y1) <= border_exclude) | (np.abs(gy - y2) <= border_exclude)
    on_border = (
        (near_v & (gy >= y1 - border_exclude) & (gy <= y2 + border_exclude))
        | (near_h & (gx >= x1 - border_exclude) & (gx <= x2 + border_exclude))
    )
    for k, (r, g, b) in enumerate(KEYPOINT_COLORS_RGB):
        dist = (
            np.abs(sub[..., 0] - r) + np.abs(sub[..., 1] - g) + np.abs(sub[..., 2] - b)
        )
        m = (dist < max_dist) & ~on_border
        if int(m.sum()) < min_px:
            continue
        dmask = dist[m].astype(np.float32)
        wgt = np.maximum(max_dist - dmask, 1.0)
        ys, xs = np.nonzero(m)
        cx = float((xs * wgt).sum() / wgt.sum()) + ox
        cy = float((ys * wgt).sum() / wgt.sum()) + oy
        out[k] = (cx, cy, 1.0)
    return out


def recover_all(goldens: dict, ref_dir: str) -> dict:
    from facedet_tpu_torch.data.native_loader import load_image

    images = {}
    n_faces = n_kpts = 0
    for key, rec in sorted(goldens["images"].items()):
        detail_path = _find_detail_image(ref_dir, key)
        if detail_path is None:
            continue
        detail = load_image(detail_path)
        faces = []
        for f in rec["faces"]:
            kpts = recover_face_keypoints(detail, f["bbox"])
            faces.append(
                {
                    "face_index": f["face_index"],
                    "bbox": f["bbox"],
                    "kpts": [[round(float(v), 1) for v in row] for row in kpts],
                }
            )
            n_faces += 1
            n_kpts += int(kpts[:, 2].sum())
        images[key] = {"detail": os.path.relpath(detail_path, ref_dir), "faces": faces}
    return {
        "provenance": "color-matched keypoint dots recovered from the "
        "reference's committed *_detail.jpg renders "
        "(utils/visualization.py:26-76 fixed per-landmark draw colors)",
        "n_faces": n_faces,
        "n_keypoints_recovered": n_kpts,
        "images": images,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--goldens", default=GOLDENS_PATH)
    ap.add_argument("--ref-dir", default=REF_DIR)
    ap.add_argument("--out", default=os.path.join("runs", "golden_keypoints", "golden_keypoints.json"))
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.goldens) as f:
        goldens = json.load(f)
    out = recover_all(goldens, args.ref_dir)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(
        f"{len(out['images'])} images, {out['n_faces']} faces, "
        f"{out['n_keypoints_recovered']} keypoints -> {args.out}"
    )


if __name__ == "__main__":
    main()
