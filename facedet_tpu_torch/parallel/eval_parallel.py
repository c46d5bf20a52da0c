"""Data-parallel evaluation: round-robin the image stream over devices
(counterpart of facedet_tpu/parallel/eval_parallel.py).

Each image's sliced pipeline runs on its assigned device with a replica of
the weights there; the per-image merge is self-contained, so there is no
cross-device dependency and no collective. One process drives every device.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Optional

import numpy as np
import torch

__all__ = ["predict_stream_multidevice"]


def _default_devices(detection_model) -> list[torch.device]:
    if detection_model.device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [detection_model.device]


def predict_stream_multidevice(
    images: Iterable[np.ndarray],
    detection_model,
    devices: Optional[list] = None,
    window_per_device: int = 2,
    raw: bool = True,
    **sliced_kwargs,
):
    """Yield results in submission order while keeping up to
    ``window_per_device * len(devices)`` images in flight across devices.
    ``devices`` defaults to every CUDA device (the model's own device when
    it lies on the CPU); the detector is replicated once per device."""
    from facedet_tpu_torch.engine.predict import _dispatch_sliced, _prepare_image, _replica
    from facedet_tpu_torch.engine.prediction import PredictionResult, detections_to_object_predictions
    from facedet_tpu_torch.utils.profiling import SPANS

    devices = [torch.device(d) for d in (devices or _default_devices(detection_model))]
    n_dev = len(devices)
    replicas = [_replica(detection_model, d) for d in devices]

    opts = dict(
        slice_height=sliced_kwargs.get("slice_height"),
        slice_width=sliced_kwargs.get("slice_width"),
        overlap_height_ratio=sliced_kwargs.get("overlap_height_ratio", 0.2),
        overlap_width_ratio=sliced_kwargs.get("overlap_width_ratio", 0.2),
        perform_standard_pred=sliced_kwargs.get("perform_standard_pred", True),
        postprocess_type=sliced_kwargs.get("postprocess_type", "NMS"),
        postprocess_match_metric=sliced_kwargs.get("postprocess_match_metric", "IOU"),
        postprocess_match_threshold=sliced_kwargs.get("postprocess_match_threshold", 0.5),
        postprocess_class_agnostic=sliced_kwargs.get("postprocess_class_agnostic", True),
        auto_slice_resolution=True,
        merge_capacity=sliced_kwargs.get("merge_capacity", 1024),
        input_format="rgb",
        fetch_capacity=None,
        mesh=None,
    )
    inflight: deque = deque()

    def finalize(img, fetch):
        merged = fetch.result()
        if raw:
            return merged
        preds = detections_to_object_predictions(
            merged, detection_model.category_mapping, full_shape=tuple(img.shape[:2])
        )
        return PredictionResult(image=img, object_prediction_list=preds, detections=merged)

    for i, image in enumerate(images):
        img = _prepare_image(image)
        with SPANS.span("request"):  # the dispatch; the fetch's wait joins it by id
            fetch = _dispatch_sliced(img, replicas[i % n_dev], opts)[0]
        inflight.append((img, fetch))
        if len(inflight) >= window_per_device * n_dev:
            yield finalize(*inflight.popleft())
    while inflight:
        yield finalize(*inflight.popleft())
