"""SAHI hyper-parameter grid search.

Reference: utils/tuning_sahi.py — three grids (quick/balanced/comprehensive,
:24-51) over slice_size x overlap x postprocess x match-metric x threshold,
scored with COCO mAP over a val set (:54-169), ranked by mAP@50-95 and written
to ``sahi_tuning_complete_results.json`` + ``best_sahi_config.json``
(:272-288). The scorer is the self-contained eval/coco_map.py instead of
pycocotools.

Counterpart of facedet_tpu/eval/tuning.py: the grid and the scorer are
copied; each configuration runs the port's ``get_sliced_prediction``.
"""
from __future__ import annotations

import itertools
import json
import os
import time
from typing import Callable, Optional

import numpy as np

from facedet_tpu_torch.eval.coco_map import coco_map

__all__ = ["GRIDS", "grid_configs", "evaluate_sahi_config", "run_grid_search"]

# reference utils/tuning_sahi.py:24-51
GRIDS: dict[str, dict] = {
    "quick": {
        "slice_size": [512, 640],
        "overlap": [0.2, 0.3],
        "postprocess": ["GREEDYNMM"],
        "metric": ["IOS"],
        "threshold": [0.5],
    },
    "balanced": {
        "slice_size": [320, 512, 640],
        "overlap": [0.1, 0.2, 0.3],
        "postprocess": ["NMS", "GREEDYNMM"],
        "metric": ["IOS", "IOU"],
        "threshold": [0.5],
    },
    "comprehensive": {
        "slice_size": [320, 512, 640, 800],
        "overlap": [0.1, 0.2, 0.3, 0.4],
        "postprocess": ["NMS", "GREEDYNMM"],
        "metric": ["IOS", "IOU"],
        "threshold": [0.3, 0.5, 0.7],
    },
}


def grid_configs(grid_name: str = "balanced") -> list[dict]:
    grid = GRIDS[grid_name]
    keys = list(grid)
    return [dict(zip(keys, vals)) for vals in itertools.product(*(grid[k] for k in keys))]


def evaluate_sahi_config(
    config: dict,
    detection_model,
    dataset: list[dict],
    image_loader: Callable[[str], np.ndarray],
    max_images: Optional[int] = None,
) -> dict:
    """Run sliced prediction with ``config`` over a COCO-style dataset
    (list of {file_name, image_id, gt: [[x,y,w,h], ...]}) and score with COCO
    mAP (reference utils/tuning_sahi.py:54-169). Per-image failures are
    skipped, mirroring :94-126."""
    from facedet_tpu_torch.engine.predict import get_sliced_prediction

    preds, gts = [], []
    errors = 0
    t0 = time.perf_counter()
    for item in dataset[:max_images]:
        for g in item["gt"]:
            gts.append({"image_id": item["image_id"], "bbox": list(g)})
        try:
            img = image_loader(item["file_name"])
            result = get_sliced_prediction(
                img,
                detection_model,
                slice_height=config["slice_size"],
                slice_width=config["slice_size"],
                overlap_height_ratio=config["overlap"],
                overlap_width_ratio=config["overlap"],
                postprocess_type=config["postprocess"],
                postprocess_match_metric=config["metric"],
                postprocess_match_threshold=config["threshold"],
                postprocess_class_agnostic=True,
            )
            preds.extend(result.to_coco_predictions(image_id=item["image_id"]))
        except Exception:
            errors += 1
            continue
    metrics = coco_map(preds, gts)
    return {
        **config,
        **metrics,
        "errors": errors,
        "seconds": time.perf_counter() - t0,
    }


def run_grid_search(
    detection_model,
    dataset: list[dict],
    image_loader: Callable[[str], np.ndarray],
    grid_name: str = "balanced",
    output_dir: str = "output",
    max_images: Optional[int] = None,
    save: bool = True,
) -> dict:
    """Full search -> ranked results + best config artifacts
    (reference utils/tuning_sahi.py:172-288)."""
    configs = grid_configs(grid_name)
    results = []
    for i, cfg in enumerate(configs):
        res = evaluate_sahi_config(cfg, detection_model, dataset, image_loader, max_images)
        results.append(res)
        print(
            f"[{i + 1}/{len(configs)}] slice={cfg['slice_size']} overlap={cfg['overlap']} "
            f"{cfg['postprocess']}/{cfg['metric']}@{cfg['threshold']} "
            f"-> mAP={res['map']:.4f} mAP50={res['map50']:.4f}"
        )
    results.sort(key=lambda r: -r["map"])
    best = results[0] if results else {}
    out = {"grid": grid_name, "num_configs": len(configs), "results": results, "best": best}
    if save:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "sahi_tuning_complete_results.json"), "w") as f:
            json.dump(out, f, indent=2)
        with open(os.path.join(output_dir, "best_sahi_config.json"), "w") as f:
            json.dump(
                {k: best[k] for k in ("slice_size", "overlap", "postprocess", "metric", "threshold")}
                if best
                else {},
                f,
                indent=2,
            )
    return out
