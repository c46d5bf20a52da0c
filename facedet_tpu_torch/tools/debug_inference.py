"""Model-wrapper A/B parity and keypoint debug harnesses (counterpart of
facedet_tpu/tools/debug_inference.py).

``compare_direct_vs_wrapper`` runs one image through the detector's
letterboxed single-image path at several sizes, comparing counts,
confidence ranges and box sizes, with the device's memory statistics;
``wrapper_config_info`` introspects the wrapper; ``debug_keypoints``
checks that the pose head emits keypoints.
"""
from __future__ import annotations

import numpy as np


def compare_direct_vs_wrapper(
    image: np.ndarray, detection_model, image_sizes=(640, 960, 1024, 1280)
) -> list[dict]:
    """A/B parity sweep across letterbox sizes, surfacing any size-dependent
    decode drift (the JAX tool's rows, key for key)."""
    from facedet_tpu_torch.utils.profiling import device_memory_stats

    rows = []
    orig_size = detection_model.image_size
    try:
        for size in image_sizes:
            detection_model.image_size = size
            detection_model.perform_inference(image)
            det = detection_model.original_predictions.to_numpy()
            keep = det["scores"] >= detection_model.confidence_threshold
            boxes, scores = det["boxes"][keep], det["scores"][keep]
            sizes = (
                np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
                if len(boxes)
                else np.zeros(0)
            )
            rows.append(
                {
                    "imgsz": size,
                    "detections": int(keep.sum()),
                    "conf_min": float(scores.min()) if len(scores) else None,
                    "conf_max": float(scores.max()) if len(scores) else None,
                    "box_size_mean": float(sizes.mean()) if len(sizes) else None,
                    "memory": device_memory_stats(detection_model.device),
                }
            )
    finally:
        detection_model.image_size = orig_size
    return rows


def wrapper_config_info(detection_model) -> dict:
    """Wrapper introspection."""
    return {
        "type": type(detection_model).__name__,
        "confidence_threshold": detection_model.confidence_threshold,
        "image_size": detection_model.image_size,
        "category_mapping": detection_model.category_mapping,
        "num_keypoints": detection_model.num_keypoints,
        "model_path": detection_model.model_path,
    }


def debug_keypoints(image: np.ndarray, detection_model) -> dict:
    """Check that the pose head emits keypoints."""
    detection_model.perform_inference(image)
    det = detection_model.original_predictions.to_numpy()
    out = {
        "num_detections": int(det["boxes"].shape[0]),
        "kpts_shape": list(det["kpts"].shape),
        "has_keypoints": det["kpts"].shape[0] > 0 and det["kpts"].shape[1] > 0,
    }
    if det["kpts"].shape[0]:
        out["first_keypoints"] = det["kpts"][0].tolist()
    return out
