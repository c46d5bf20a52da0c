"""SCRFD/RetinaFace detection model wrappers (counterpart of
facedet_tpu/engine/scrfd_wrapper.py).

``ScrfdDetectionModel`` is the SCRFD ``DetectionModel``: random init,
a ``.npz`` of flax variables, or an insightface-layout ``.onnx`` graph run
by models/onnx_import.py. ``FaceAnalysis`` is the insightface-style facade
(prepare/get) of the raw direct-detect path, with the det-size guard and
the bbox clamp.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from facedet_tpu_torch.core.detections import Detections
from facedet_tpu_torch.engine.detector import DetectionModel, _exact_float32
from facedet_tpu_torch.models.scrfd import (
    SCRFD_VARIANTS,
    Scrfd,
    decode_scrfd,
    decode_scrfd_flat,
)
from facedet_tpu_torch.models.yolo_decode import decode_to_detections


class ScrfdDetectionModel(DetectionModel):
    """SCRFD DetectionModel. An ``.onnx`` graph takes a tile batch as
    engine/onnx_wrapper.run_tile_batch says."""

    def __init__(
        self,
        *args,
        variant: str = "scrfd_2.5g",
        det_thresh: Optional[float] = None,
        dtype: str = "bfloat16",
        seed: int = 0,
        **kwargs,
    ):
        self.variant = variant
        self.dtype = dtype
        self.seed = seed
        if det_thresh is not None:
            kwargs["confidence_threshold"] = det_thresh
        super().__init__(*args, **kwargs)

    def load_model(self) -> None:
        from facedet_tpu_torch.models.from_jax import load_jax_variables, load_params_npz
        from facedet_tpu_torch.models.init import random_init

        cfg = SCRFD_VARIANTS[self.variant]
        self.cfg = dataclasses.replace(cfg, dtype=self.dtype)
        self._onnx = None
        if str(self.model_path).endswith(".onnx"):
            from facedet_tpu_torch.engine.onnx_wrapper import load_onnx_graph

            load_onnx_graph(self)
            return
        model = Scrfd(self.cfg)
        if self.model_path is None:
            random_init(model, self.seed)
        elif str(self.model_path).endswith(".npz"):
            load_jax_variables(model, load_params_npz(self.model_path))
        else:
            raise ValueError(f"unsupported checkpoint format: {self.model_path}")
        self.model = model.set_dtypes().to(self.device).eval()

    def tile_forward_nchw(self, tiles: torch.Tensor, conf_threshold: float) -> Detections:
        with torch.inference_mode(), _exact_float32(self.dtype == "float32" or self._onnx is not None):
            if self._onnx is not None:
                from facedet_tpu_torch.engine.onnx_wrapper import run_tile_batch

                # insightface blob semantics: (pix*255 - 127.5)/128, NCHW, RGB
                x = (tiles.to(torch.float32) * 255.0 - 127.5) / 128.0
                outs = run_tile_batch(self, x)
                outs = [o.reshape(o.shape[0], -1, o.shape[-1]) for o in outs]
                preds = decode_scrfd_flat(outs, tuple(tiles.shape[2:4]))
            else:
                level_outs = self.model.forward_nchw(tiles)
                preds = decode_scrfd(level_outs, num_keypoints=self.cfg.num_keypoints)
            return decode_to_detections(
                preds,
                conf_threshold=conf_threshold,
                max_detections=self.max_detections_per_tile,
                nms_iou=0.4,  # insightface SCRFD default nms_thresh
                class_agnostic=True,
            )


@dataclasses.dataclass
class Face:
    """insightface-style result record (.bbox xyxy, .kps [5,2], .det_score)."""

    bbox: np.ndarray
    kps: np.ndarray
    det_score: float


class FaceAnalysis:
    """Facade matching insightface.app.FaceAnalysis for the raw direct-detect
    path. ``device`` goes to the ``ScrfdDetectionModel`` that ``prepare``
    builds."""

    def __init__(
        self,
        name: str = "scrfd_2.5g",
        providers: Optional[list] = None,  # accepted for signature parity
        model_path: Optional[str] = None,
        device=None,
    ):
        self.variant = name if name in SCRFD_VARIANTS else "scrfd_2.5g"
        self.model_path = model_path
        self.device = device
        self.det_size = (640, 640)
        self.det_thresh = 0.5
        self._model: Optional[ScrfdDetectionModel] = None

    def prepare(self, ctx_id: int = 0, det_size=(640, 640), det_thresh: float = 0.5):
        """det_size guard: non-positive sizes self-heal to 640."""
        w, h = det_size
        if w <= 0 or h <= 0:
            w = h = 640
        self.det_size = (int(w), int(h))
        self.det_thresh = float(det_thresh)
        self._model = ScrfdDetectionModel(
            variant=self.variant,
            model_path=self.model_path,
            confidence_threshold=self.det_thresh,
            image_size=max(self.det_size),
            device=self.device,
        )

    def get(self, image: np.ndarray) -> list[Face]:
        if self._model is None:
            self.prepare()
        self._model.perform_inference(np.asarray(image))
        arr = self._model.original_predictions.to_numpy()
        keep = arr["scores"] >= self.det_thresh
        faces = []
        h, w = np.asarray(image).shape[:2]
        for box, score, kpts in zip(arr["boxes"][keep], arr["scores"][keep], arr["kpts"][keep]):
            box = np.clip(box, [0, 0, 0, 0], [w, h, w, h])  # clamp to the image
            faces.append(Face(bbox=box, kps=kpts[:, :2].copy(), det_score=float(score)))
        return faces
