"""Generic ONNX detection model: run any exported detector graph through
models/onnx_import.py (counterpart of facedet_tpu/engine/onnx_wrapper.py).

Any ultralytics ``model.export(format="onnx")`` artifact, YOLO(-pose) or
RT-DETR, plugs into the same ``DetectionModel`` contract and therefore into
the sliced pipeline and the CLIs, with no onnxruntime.

Supported output layouts (auto-detected, or forced via ``output_layout``):

  * ``yolo``   — ``[B, 4+nc(+K*3), A]``: cxcywh **pixel** boxes + sigmoided
    class scores (+ optional pose keypoint rows), needs NMS.
  * ``rtdetr`` — ``[B, Q, 4+nc]``: cxcywh boxes **normalised** to [0,1] +
    class scores, set-based (no NMS), denormalised per axis.

A tile batch (``run_tile_batch``): the JAX package maps the graph over the
tiles with an inner batch of 1, because graphs exported at batch 1 have the
1 baked into their ``Reshape`` constants. The port does the same with a loop:
one run of the graph per tile, which gives the same numbers for any graph,
whatever batch axis it declares.
"""
from __future__ import annotations

from typing import Optional

import torch

from facedet_tpu_torch.core.detections import Detections
from facedet_tpu_torch.engine.detector import DetectionModel, _exact_float32
from facedet_tpu_torch.models.yolo_decode import decode_to_detections

__all__ = ["OnnxDetectionModel", "load_onnx_graph", "run_tile_batch"]


def load_onnx_graph(model: DetectionModel) -> None:
    """Import ``model.model_path`` and set ``model._onnx``, the weights on
    the model's device (``model.variables["params"]``) and ``image_size``
    from the graph's declared input where the caller gave none."""
    from facedet_tpu_torch.models.onnx_import import import_onnx

    model._onnx = import_onnx(str(model.model_path))
    model.model = None
    model.variables = {"params": model._onnx.params_on(model.device)}
    hw = model._onnx.input_hw()
    if hw and not model.image_size:
        model.image_size = max(hw)


def run_tile_batch(model: DetectionModel, x: torch.Tensor) -> tuple:
    """Run ``model._onnx`` on tiles x [T,C,H,W], one tile at a time; every
    output comes back as [T, 1, ...] (a tile axis over the graph's own batch
    of 1)."""
    params = model.variables["params"]
    per_tile = [model._onnx(params, x[i : i + 1]) for i in range(x.shape[0])]
    return tuple(torch.stack(outs) for outs in zip(*per_tile))


class OnnxDetectionModel(DetectionModel):
    def __init__(
        self,
        *args,
        output_layout: str = "auto",
        num_keypoints: Optional[int] = None,
        nms_iou: float = 0.7,
        **kwargs,
    ):
        if output_layout not in ("auto", "yolo", "rtdetr"):
            raise ValueError(f"unknown output_layout {output_layout!r}")
        self.output_layout = output_layout
        self._num_keypoints = num_keypoints
        self.nms_iou = nms_iou
        super().__init__(*args, **kwargs)

    @property
    def num_keypoints(self) -> int:
        return self._num_keypoints or 5

    def load_model(self) -> None:
        if not self.model_path:
            raise ValueError("OnnxDetectionModel requires model_path=<file.onnx>")
        load_onnx_graph(self)

    def _classify_layout(self, out) -> str:
        if self.output_layout != "auto":
            return self.output_layout
        # YOLO exports are channels-first [B, C, A] with far more anchors than
        # channels; RT-DETR is [B, Q, 4+nc] with Q >> channels
        return "yolo" if out.shape[1] < out.shape[2] else "rtdetr"

    def tile_forward_nchw(self, tiles: torch.Tensor, conf_threshold: float) -> Detections:
        # ultralytics export contract: float32 [0,1] RGB NCHW
        with torch.inference_mode(), _exact_float32(True):
            out = run_tile_batch(self, tiles.to(torch.float32))[0]
            out = out.reshape((tiles.shape[0],) + tuple(out.shape[-2:]))
            layout = self._classify_layout(out)

            if layout == "yolo":
                out = out.transpose(1, 2)  # [T, A, C]
                nc = out.shape[-1] - 4
                nk = 0
                if self._num_keypoints:
                    nk = self._num_keypoints
                    nc -= nk * 3
                preds = {"boxes": _cxcywh_to_xyxy(out[..., :4]), "scores": out[..., 4 : 4 + nc]}
                if nk:
                    preds["kpts"] = out[..., 4 + nc :].reshape(out.shape[0], out.shape[1], nk, 3)
                return decode_to_detections(
                    preds,
                    conf_threshold=conf_threshold,
                    max_detections=self.max_detections_per_tile,
                    nms_iou=self.nms_iou,
                    class_agnostic=True,
                )

            # rtdetr: normalised cxcywh, set predictions -> top-k, no NMS.
            # Denormalise per axis: tiles can be non-square.
            h, w = tiles.shape[2], tiles.shape[3]
            wh = torch.tensor([w, h, w, h], dtype=out.dtype, device=out.device)
            return decode_to_detections(
                {"boxes": _cxcywh_to_xyxy(out[..., :4]) * wh, "scores": out[..., 4:]},
                conf_threshold=conf_threshold,
                max_detections=self.max_detections_per_tile,
                with_nms=False,
            )


def _cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.split(1, dim=-1)
    return torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
