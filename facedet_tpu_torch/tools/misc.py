"""Miscellaneous tools: device probe, training-curve plot, detector
validation (counterpart of facedet_tpu/tools/misc.py).

  * ``check_devices``: the CUDA devices torch sees;
  * ``plot_results``: a training-curve PNG from a results.csv, or ``None``
    where matplotlib is missing;
  * ``validate_detector``: COCO mAP over a validation set through the
    port's ``get_prediction`` / ``get_sliced_prediction``.
"""
from __future__ import annotations

import csv
import os
from typing import Callable, Optional

import numpy as np


def check_devices() -> dict:
    """Device probe: the backend ("cuda" or "cpu") and the CUDA devices."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "backend": "cuda" if n else "cpu",
        "num_devices": n,
        "devices": [f"cuda:{i} ({torch.cuda.get_device_name(i)})" for i in range(n)],
    }


def plot_results(results_csv: str, output_png: Optional[str] = None) -> Optional[str]:
    """Training-curve PNG from a results.csv; ``None`` without matplotlib
    or without rows."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    with open(results_csv) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None
    keys = [k for k in rows[0] if k != "epoch"]
    epochs = [float(r["epoch"]) for r in rows]
    fig, ax = plt.subplots(figsize=(8, 5))
    for k in keys:
        ax.plot(epochs, [float(r[k]) for r in rows], label=k)
    ax.set_xlabel("epoch")
    ax.legend()
    ax.grid(alpha=0.3)
    out = output_png or os.path.splitext(results_csv)[0] + ".png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def validate_detector(
    detection_model,
    dataset: list[dict],
    image_loader: Callable[[str], np.ndarray],
    use_sahi: bool = False,
    slice_size: int = 640,
    overlap: float = 0.2,
    perform_standard_pred: bool = True,
) -> dict:
    """COCO mAP over {file_name, image_id, gt: [[x, y, w, h], ...]} items."""
    from facedet_tpu_torch.engine.predict import get_prediction, get_sliced_prediction
    from facedet_tpu_torch.eval.coco_map import coco_map

    preds, gts = [], []
    for item in dataset:
        for g in item["gt"]:
            gts.append({"image_id": item["image_id"], "bbox": list(g)})
        img = image_loader(item["file_name"])
        if use_sahi:
            result = get_sliced_prediction(
                img,
                detection_model,
                slice_height=slice_size,
                slice_width=slice_size,
                overlap_height_ratio=overlap,
                overlap_width_ratio=overlap,
                perform_standard_pred=perform_standard_pred,
                postprocess_class_agnostic=True,
            )
        else:
            result = get_prediction(img, detection_model)
        preds.extend(result.to_coco_predictions(image_id=item["image_id"]))
    return coco_map(preds, gts)
