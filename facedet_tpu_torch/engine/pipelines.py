"""Composed pipelines: detect-first (v1) and enhance-first (v2).

Counterpart of facedet_tpu/engine/pipelines.py:
  * v1: adaptive slicing -> SAHI detect -> save face crops -> Real-ESRGAN on
    the crops;
  * v2: whole-image Real-ESRGAN -> SAHI detect on the enhanced image ->
    divide coordinates by the scale factor -> results in original
    coordinates;
  * the bounded-enhancement gate: a cheap low-confidence pass decides
    whether SR is worth running.

Each pipeline stays on the device from end to end: the enhanced image
tensor feeds the tile gather directly. Each call is a ``request`` span of
``utils.profiling.SPANS``, its enhancement an ``enhance`` span, and the
sliced detection inside it a child ``request``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from facedet_tpu_torch.core.detections import Detections
from facedet_tpu_torch.engine.detector import DetectionModel
from facedet_tpu_torch.engine.enhancer import FaceEnhancer, image_to_device
from facedet_tpu_torch.engine.predict import get_sliced_prediction
from facedet_tpu_torch.engine.prediction import PredictionResult, detections_to_object_predictions
from facedet_tpu_torch.ops.tiler import fixed_grid_slice_params, half_image_slice_size
from facedet_tpu_torch.utils.profiling import SPANS

__all__ = [
    "detect_first_pipeline",
    "enhance_first_pipeline",
    "quick_face_analysis",
]


def _slice_params(policy: str, h: int, w: int, cfg) -> tuple[int, int, float, float]:
    if policy == "half_image":
        sh, sw = half_image_slice_size(h, w)
        return sh, sw, cfg.overlap_height_ratio, cfg.overlap_width_ratio
    if policy == "fixed_grid":
        sh, sw, ov = fixed_grid_slice_params(h, w)
        return sh, sw, ov, ov
    return (
        cfg.slice_height or 640,
        cfg.slice_width or 640,
        cfg.overlap_height_ratio,
        cfg.overlap_width_ratio,
    )


def detect_first_pipeline(
    image: np.ndarray,
    detection_model: DetectionModel,
    enhancer: Optional[FaceEnhancer] = None,
    slice_policy: str = "half_image",
    slice_config=None,
    postprocess_config=None,
    crops_dir: Optional[str] = None,
    output_dir: Optional[str] = None,
) -> tuple[PredictionResult, dict]:
    """Pipeline v1: SAHI detect -> crop faces -> enhance crops.

    Returns (PredictionResult, enhancement stats dict)."""
    from facedet_tpu_torch.utils.config import PostprocessConfig, SliceConfig
    from facedet_tpu_torch.utils.viz import save_face_crops

    sc = slice_config or SliceConfig()
    pc = postprocess_config or PostprocessConfig()
    h, w = image.shape[:2]
    sh, sw, oh, ow = _slice_params(slice_policy, h, w, sc)
    with SPANS.span("request"):
        result = get_sliced_prediction(
            image,
            detection_model,
            slice_height=sh,
            slice_width=sw,
            overlap_height_ratio=oh,
            overlap_width_ratio=ow,
            perform_standard_pred=sc.perform_standard_pred,
            postprocess_type=pc.postprocess_type,
            postprocess_match_metric=pc.postprocess_match_metric,
            postprocess_match_threshold=pc.postprocess_match_threshold,
            postprocess_class_agnostic=pc.postprocess_class_agnostic,
        )
        stats: dict = {"total": 0, "enhanced": 0, "failed": 0}
        if enhancer is not None and crops_dir is not None:
            from facedet_tpu_torch.engine.enhancer import enhance_face_crops_batch

            with SPANS.span("enhance") as enhanced:
                save_face_crops(image, result.object_prediction_list, crops_dir)
                out_dir = output_dir or (crops_dir.rstrip("/") + "_enhanced")
                stats = enhance_face_crops_batch(crops_dir, out_dir, enhancer)
            result.durations_in_seconds["enhance"] = enhanced.seconds
    return result, stats


def enhance_first_pipeline(
    image: np.ndarray,
    detection_model: DetectionModel,
    enhancer: FaceEnhancer,
    slice_policy: str = "fixed_grid",
    slice_config=None,
    postprocess_config=None,
    outscale: Optional[float] = None,
) -> PredictionResult:
    """Pipeline v2: whole-image SR -> SAHI detect on enhanced -> coords / scale.

    The returned PredictionResult carries the ORIGINAL image with boxes
    mapped back to original coordinates; the enhanced array is attached as
    ``result.enhanced_image`` (uint8)."""
    from facedet_tpu_torch.utils.config import PostprocessConfig, SliceConfig

    sc = slice_config or SliceConfig()
    pc = postprocess_config or PostprocessConfig()
    scale = float(outscale if outscale is not None else enhancer.outscale)
    with SPANS.span("request"):
        with SPANS.span("enhance") as enhanced_span:
            img = np.asarray(image)
            enhanced = enhancer.enhance_array(image_to_device(img, enhancer.device), outscale=scale)
            if enhanced.is_cuda:
                torch.cuda.synchronize(enhanced.device)  # honest enhance timing

        eh, ew = int(enhanced.shape[0]), int(enhanced.shape[1])
        sh, sw, oh, ow = _slice_params(slice_policy, eh, ew, sc)
        # the SR output stays ON THE DEVICE through the sliced detection (a x4
        # output holds 16x the original pixels: fetching it only to upload the
        # padded canvas again costs two transfers of the largest tensor in the
        # system); the single display fetch below doubles as enhanced_image
        result = get_sliced_prediction(
            enhanced,
            detection_model,
            slice_height=sh,
            slice_width=sw,
            overlap_height_ratio=oh,
            overlap_width_ratio=ow,
            perform_standard_pred=sc.perform_standard_pred,
            postprocess_type=pc.postprocess_type,
            postprocess_match_metric=pc.postprocess_match_metric,
            postprocess_match_threshold=pc.postprocess_match_threshold,
            postprocess_class_agnostic=pc.postprocess_class_agnostic,
        )

        # map detections back to original coordinates (divide by scale)
        det = result.detections
        h, w = img.shape[:2]
        kpts = det.kpts.clone()
        kpts[..., :2] /= scale
        det = Detections(
            boxes=(det.boxes / scale).clamp(0, max(h, w)),
            scores=det.scores,
            classes=det.classes,
            kpts=kpts,
            valid=det.valid,
        )
        preds = detections_to_object_predictions(det, detection_model.category_mapping, full_shape=(h, w))
        out = PredictionResult(
            image=img,
            object_prediction_list=preds,
            durations_in_seconds={**result.durations_in_seconds, "enhance": enhanced_span.seconds},
            detections=det,
        )
        out.enhanced_image = result.image  # type: ignore[attr-defined]
        return out


def quick_face_analysis(
    image: np.ndarray,
    detection_model: DetectionModel,
    small_face_px: float = 50.0,
    small_ratio_threshold: float = 0.5,
    probe_conf: float = 0.05,
) -> bool:
    """Bounded-enhancement gate: a cheap low-confidence full-image pass;
    returns True when SR is warranted: small-face ratio > 0.5 or mean face
    size < 50 px."""
    old_conf = detection_model.confidence_threshold
    try:
        detection_model.confidence_threshold = probe_conf
        detection_model.perform_inference(np.asarray(image))
        det = detection_model.original_predictions
    finally:
        detection_model.confidence_threshold = old_conf
    arr = det.to_numpy()
    boxes = arr["boxes"][arr["scores"] >= probe_conf]
    if boxes.shape[0] == 0:
        return False
    sizes = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    small_ratio = float(np.mean(sizes < small_face_px))
    return small_ratio > small_ratio_threshold or float(sizes.mean()) < small_face_px
