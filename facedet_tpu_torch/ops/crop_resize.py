"""On-device crop-and-resize (ROI extraction) for the detect -> crop ->
enhance chain.

Counterpart of facedet_tpu/ops/crop_resize.py. Boxes of any size are cut
from the image and resampled to one ``[N, S, S, 3]`` batch on the image's
device, so detection, cropping and SR chain without a trip through files.
The JAX function is ``jax.vmap`` of ``jax.image.scale_and_translate`` with a
per-box scale and translation; here the per-box weight matrices of
ops/image.compute_weight_mat are applied as one batched pair of products.
"""
from __future__ import annotations

import numpy as np
import torch

from facedet_tpu_torch.ops.image import compute_weight_mat, resize_chw

__all__ = ["crop_and_resize", "crop_and_resize_chw", "paste_resized_crops"]

# boxes per pair of products: the first product's result is
# [chunk, C, out_size, W] floats
_BOX_CHUNK = 64


def crop_and_resize_chw(image: torch.Tensor, boxes: torch.Tensor, out_size: int = 128,
                        margin: float = 0.0) -> torch.Tensor:
    """image [C,H,W] float; boxes [N,4] xyxy -> crops [N,C,out_size,out_size]."""
    c, h, w = image.shape
    boxes = boxes.to(device=image.device, dtype=torch.float32)
    x1, y1, x2, y2 = boxes.unbind(-1)
    side = torch.maximum(x2 - x1, y2 - y1).clamp(min=1.0)
    pad = margin * side
    x1, y1 = x1 - pad, y1 - pad
    bw = (x2 + pad - x1).clamp(min=1.0)
    bh = (y2 + pad - y1).clamp(min=1.0)
    scale = out_size / torch.maximum(bw, bh)
    out = []
    for i in range(0, boxes.shape[0], _BOX_CHUNK):
        s = scale[i : i + _BOX_CHUNK]
        wh = compute_weight_mat(h, out_size, s, -y1[i : i + _BOX_CHUNK] * s, device=image.device).to(image.dtype)
        ww = compute_weight_mat(w, out_size, s, -x1[i : i + _BOX_CHUNK] * s, device=image.device).to(image.dtype)
        rows = torch.matmul(wh.transpose(1, 2)[:, None], image[None])  # [n,C,S,W]
        out.append(torch.matmul(rows, ww[:, None]))  # [n,C,S,S]
    if not out:
        return image.new_zeros((0, c, out_size, out_size))
    return torch.cat(out) if len(out) > 1 else out[0]


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor, out_size: int = 128,
                    margin: float = 0.0) -> torch.Tensor:
    """image [H,W,3] float; boxes [N,4] xyxy -> crops [N,out_size,out_size,3].

    Each box (optionally expanded by ``margin`` * max side) is resampled to
    the output square with aspect preserved: the square window covers the
    box's max side from its top-left corner, so non-square boxes include the
    adjoining image context (zeros only beyond the image) instead of black
    letterbox bars. The kernel is linear, widened where a face is larger
    than ``out_size``. A degenerate box is treated as one pixel wide."""
    return crop_and_resize_chw(image.permute(2, 0, 1), boxes, out_size, margin).permute(0, 2, 3, 1)


def paste_resized_crops(crops, boxes, out_hw: tuple[int, int]) -> np.ndarray:
    """Host-side helper: place enhanced square crops [N,S,S,3] back at their
    (scaled) box positions on a canvas, for visual composites; returns numpy
    uint8."""
    h, w = out_hw
    canvas = np.zeros((h, w, 3), np.float32)
    crops_t = torch.as_tensor(np.asarray(crops.cpu() if isinstance(crops, torch.Tensor) else crops), dtype=torch.float32)
    boxes_np = np.asarray(boxes.cpu() if isinstance(boxes, torch.Tensor) else boxes)
    for crop, box in zip(crops_t, boxes_np):
        x1, y1, x2, y2 = (int(round(float(v))) for v in box)
        x1, y1 = max(0, x1), max(0, y1)
        x2, y2 = min(w, x2), min(h, y2)
        if x2 <= x1 or y2 <= y1:
            continue
        resized = resize_chw(crop.permute(2, 0, 1), y2 - y1, x2 - x1)
        canvas[y1:y2, x1:x2] = resized.permute(1, 2, 0).numpy()
    return (canvas.clip(0, 1) * 255).astype(np.uint8)
