"""WIDERFACE submission-format writer/reader.

The official protocol exchanges per-image .txt files (event dir / image stem,
line 1 = image name, line 2 = detection count, then ``x y w h score`` rows).
The reference only *repairs* malformed ones (utils/fix_predictions.py:4-56);
this module writes and reads them so results interoperate with the official
toolchain end-to-end.

A copy of facedet_tpu/eval/submission.py.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["write_submission", "read_submission"]


def write_submission(
    predictions: dict[str, dict[str, np.ndarray]], output_dir: str
) -> int:
    """{event: {image_stem: [P,5] xywh+score}} -> per-image txt files under
    ``output_dir/event/stem.txt``. Returns number of files written."""
    count = 0
    for event, images in predictions.items():
        event_dir = os.path.join(output_dir, event)
        os.makedirs(event_dir, exist_ok=True)
        for stem, boxes in images.items():
            boxes = np.asarray(boxes, float).reshape(-1, 5)
            lines = [stem, str(boxes.shape[0])]
            for x, y, w, h, s in boxes:
                lines.append(f"{x:.1f} {y:.1f} {w:.1f} {h:.1f} {s:.3f}")
            with open(os.path.join(event_dir, f"{stem}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            count += 1
    return count


def read_submission(input_dir: str) -> dict[str, dict[str, np.ndarray]]:
    """Inverse of write_submission; tolerant of the missing-count malformation
    that fix_predictions repairs."""
    out: dict[str, dict[str, np.ndarray]] = {}
    for event in sorted(os.listdir(input_dir)):
        event_dir = os.path.join(input_dir, event)
        if not os.path.isdir(event_dir):
            continue
        out[event] = {}
        for fname in sorted(os.listdir(event_dir)):
            if not fname.endswith(".txt"):
                continue
            with open(os.path.join(event_dir, fname)) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
            stem = lines[0] if lines else os.path.splitext(fname)[0]
            rows = []
            start = 1
            if len(lines) > 1:
                try:
                    int(lines[1])
                    start = 2
                except ValueError:
                    start = 1
            for ln in lines[start:]:
                vals = [float(v) for v in ln.split()[:5]]
                if len(vals) == 5:
                    rows.append(vals)
            out[event][os.path.splitext(fname)[0]] = np.asarray(rows, float).reshape(-1, 5)
    return out
