"""Sliced and standard prediction drivers — the port's public inference API.

Counterpart of facedet_tpu/engine/predict.py (``get_prediction`` :1065,
``get_sliced_prediction`` :1089), RGB input. The sliced pipeline is the
JAX package's fused ``core`` (:310-330), run eagerly on the model's device:
zero-padded bucketed canvas -> /255 -> tile gather (the CHW CUDA kernel of
ops/kernels/tile_gather.py, straight into the NCHW batch the convs take) ->
detector forward over the tile batch (+ the letterboxed full-image standard
pass) -> slice-to-global shift -> truncate -> GreedyNMM/NMS merge -> clip ->
optional fetch compaction -> one copy to the host.

The batch and stream drivers, the YUV/DCT ingest formats and the device
mesh are not ported yet; they raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from facedet_tpu_torch.core.boxes import clip_boxes
from facedet_tpu_torch.core.detections import Detections, concat_detections
from facedet_tpu_torch.engine.detector import DetectionModel
from facedet_tpu_torch.engine.prediction import PredictionResult, detections_to_object_predictions
from facedet_tpu_torch.ops.image import scale_and_translate_chw
from facedet_tpu_torch.ops.kernels.tile_gather import gather_tiles_chw
from facedet_tpu_torch.ops.nms import merge_detections
from facedet_tpu_torch.ops.tiler import (
    adaptive_slice_size,
    bucket_image_dim,
    bucket_tile_count,
    compute_slice_grid,
    pad_grid_offsets,
)

__all__ = ["get_prediction", "get_sliced_prediction", "POSTPROCESS_DEFAULTS"]

POSTPROCESS_DEFAULTS = {
    "postprocess_type": "GREEDYNMM",
    "postprocess_match_metric": "IOS",
    "postprocess_match_threshold": 0.5,
    "postprocess_class_agnostic": False,
}


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not yet ported to facedet_tpu_torch")


def _shift_and_flatten(det: Detections, offsets: torch.Tensor, tile_valid: torch.Tensor) -> Detections:
    """Per-tile detections [T, k] -> flat global-coordinate detections [T*k]."""
    off_xy = offsets.to(torch.float32).flip(-1)  # (y,x) -> (x,y)
    boxes = det.boxes + off_xy.repeat(1, 2)[:, None, :]
    kpts = det.kpts.clone()
    kpts[..., :2] += off_xy[:, None, None, :]
    valid = det.valid & tile_valid[:, None]
    t, k = valid.shape
    return Detections(
        boxes=boxes.reshape(t * k, 4),
        scores=det.scores.reshape(t * k),
        classes=det.classes.reshape(t * k),
        kpts=kpts.reshape(t * k, det.kpts.shape[-2], 3),
        valid=valid.reshape(t * k),
    )


def _truncate_by_score(det: Detections, capacity: int) -> Detections:
    return det.sort_by_score().map(lambda x: x[:capacity])


def _clip_detections(det: Detections, h: int, w: int) -> Detections:
    boxes = clip_boxes(det.boxes, h, w)
    # drop boxes that clipping degenerated to zero area (fully outside image)
    nonzero = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    return Detections(
        boxes=boxes,
        scores=det.scores,
        classes=det.classes,
        kpts=det.kpts,
        valid=det.valid & nonzero,
    )


def letterbox_full(canvas_chw: torch.Tensor, true_hw: torch.Tensor, img_size: int):
    """The standard pass's input: ``jax.image.scale_and_translate`` of the
    padded canvas (antialiased linear, translation 0) into a top-left-aligned
    ``img_size``² image, at the scale of the true image size. Samples past
    the canvas get weight 0: there is no centred grey pad. Returns
    ([C, img_size, img_size], float32 scale)."""
    scale = torch.minimum(img_size / true_hw[0], img_size / true_hw[1])
    return scale_and_translate_chw(canvas_chw, img_size, img_size, scale), scale


def _prepare_image(image):
    """HWC RGB image (numpy, PIL or a torch tensor, which stays on its
    device) with gray expanded and alpha dropped."""
    if isinstance(image, tuple):
        raise _not_ported("yuv420 / dct420 ingest")
    img = image if isinstance(image, torch.Tensor) else np.asarray(image)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1) if isinstance(img, np.ndarray) else img[..., None].expand(-1, -1, 3)
    if img.shape[-1] == 4:
        img = img[..., :3]
    return img


def _display_image(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        arr = img.cpu()
        if arr.dtype != torch.uint8:
            arr = (arr.float() * 255.0).round().clamp(0, 255).to(torch.uint8)
        return arr.numpy()
    return img


def _canvas(img, bucket_h: int, bucket_w: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Zero-pad bottom/right to the bucket, move to ``device``, permute to
    CHW once and scale uint8 to [0, 1] in ``dtype``: [3, bucket_h, bucket_w]."""
    h, w = img.shape[0], img.shape[1]
    if isinstance(img, np.ndarray):
        padded = np.zeros((bucket_h, bucket_w, img.shape[2]), img.dtype)
        padded[:h, :w] = img
        dev = torch.from_numpy(padded).to(device)
    else:
        dev = torch.nn.functional.pad(img.to(device), (0, 0, 0, bucket_w - w, 0, bucket_h - h))
    chw = dev.permute(2, 0, 1).contiguous()
    return chw.to(dtype) / 255.0 if chw.dtype == torch.uint8 else chw.to(dtype)


def get_prediction(
    image,
    detection_model: DetectionModel,
    shift_amount: tuple[int, int] = (0, 0),
    full_shape: Optional[tuple[int, int]] = None,
    postprocess=None,
    verbose: int = 0,
) -> PredictionResult:
    """Single-image (or single-slice) inference."""
    img = _prepare_image(image)
    if isinstance(img, torch.Tensor):
        img = _display_image(img)
    t0 = time.perf_counter()
    detection_model.perform_inference(img)
    dt = time.perf_counter() - t0
    detection_model.convert_original_predictions(
        shift_amount=shift_amount,
        full_shape=full_shape if full_shape is not None else img.shape[:2],
    )
    return PredictionResult(
        image=img,
        object_prediction_list=detection_model.object_prediction_list,
        durations_in_seconds={"prediction": dt},
    )


def get_sliced_prediction(
    image,
    detection_model: DetectionModel,
    slice_height: Optional[int] = None,
    slice_width: Optional[int] = None,
    overlap_height_ratio: float = 0.2,
    overlap_width_ratio: float = 0.2,
    perform_standard_pred: bool = True,
    postprocess_type: str = "GREEDYNMM",
    postprocess_match_metric: str = "IOS",
    postprocess_match_threshold: float = 0.5,
    postprocess_class_agnostic: bool = False,
    auto_slice_resolution: bool = True,
    merge_capacity: int = 1024,
    merge_buffer_length: Optional[int] = None,
    input_format: str = "rgb",
    mesh=None,
    fetch_capacity: Optional[int] = None,
    verbose: int = 0,
    return_image: bool = True,
) -> PredictionResult:
    """Sliced inference with global merge, signature-compatible with the
    JAX package's ``get_sliced_prediction``. ``merge_capacity`` bounds the
    detection count entering the merge; ``merge_buffer_length`` folds into
    it. ``image`` may be a torch tensor HWC (uint8, or float in [0, 1]),
    which is padded on its device."""
    if input_format != "rgb":
        raise _not_ported(f"input_format={input_format!r}")
    if mesh is not None:
        raise _not_ported("the device mesh")
    if merge_buffer_length is not None:
        merge_capacity = min(merge_capacity, max(int(merge_buffer_length), 64))
    img = _prepare_image(image)
    h, w = img.shape[0], img.shape[1]
    durations: dict[str, float] = {}

    t0 = time.perf_counter()
    if slice_height is None or slice_width is None:
        if not auto_slice_resolution:
            raise ValueError("slice size required when auto_slice_resolution=False")
        s = adaptive_slice_size(h, w)
        slice_height = slice_height or s
        slice_width = slice_width or s
    grid = compute_slice_grid(h, w, slice_height, slice_width, overlap_height_ratio, overlap_width_ratio)
    t_bucket = bucket_tile_count(grid.num_tiles)
    offsets, tile_valid = pad_grid_offsets(grid, t_bucket)
    bucket_h = bucket_image_dim(grid.padded_h)
    bucket_w = bucket_image_dim(grid.padded_w)
    durations["slice"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    device = detection_model.device
    conf = float(detection_model.confidence_threshold)
    img_size = int(detection_model.image_size or max(slice_height, slice_width))
    # the canvas is kept in the detector's compute dtype, as in the JAX engine
    canvas_dtype = torch.bfloat16 if getattr(detection_model, "dtype", "") == "bfloat16" else torch.float32
    with torch.inference_mode():
        canvas = _canvas(img, bucket_h, bucket_w, device, canvas_dtype)
        offsets_dev = torch.from_numpy(offsets).to(device)
        tile_valid_dev = torch.from_numpy(tile_valid).to(device)
        true_hw = torch.tensor([h, w], dtype=torch.float32, device=device)

        tiles = gather_tiles_chw(canvas, offsets_dev, slice_height, slice_width)
        det = detection_model.tile_forward_nchw(tiles, conf)
        parts = [_shift_and_flatten(det, offsets_dev, tile_valid_dev)]
        if perform_standard_pred:
            full_tile, scale = letterbox_full(canvas, true_hw, img_size)
            full = detection_model.tile_forward_nchw(full_tile[None], conf).map(lambda x: x[0])
            kpts = full.kpts.clone()
            kpts[..., :2] /= scale
            parts.append(Detections(full.boxes / scale, full.scores, full.classes, kpts, full.valid))
        combined = concat_detections(parts, merge_capacity)
        merged = merge_detections(
            combined,
            mode=postprocess_type,
            match_metric=postprocess_match_metric,
            match_threshold=postprocess_match_threshold,
            class_agnostic=postprocess_class_agnostic,
        )
        merged = _clip_detections(merged, h, w)
        if fetch_capacity and fetch_capacity < merge_capacity:
            merged = _truncate_by_score(merged, fetch_capacity)
        # one copy of the whole result to the host
        merged = merged.to("cpu")
    durations["prediction"] = time.perf_counter() - t0
    durations["postprocess"] = 0.0  # merged on the device inside the pipeline

    preds = detections_to_object_predictions(merged, detection_model.category_mapping, full_shape=(h, w))
    if verbose:
        print(
            f"Performing prediction on {grid.num_tiles} slices "
            f"(bucket {t_bucket}, {slice_height}x{slice_width}): "
            + ", ".join(f"{k}={v:.3f}s" for k, v in durations.items())
        )
    return PredictionResult(
        image=_display_image(img) if return_image else None,
        object_prediction_list=preds,
        durations_in_seconds=durations,
        detections=merged,
    )
