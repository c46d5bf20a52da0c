"""RT-DETR detection model wrapper and the ``FaceDetector`` facade
(counterpart of facedet_tpu/engine/rtdetr_wrapper.py).

The detector plugs into the same ``DetectionModel`` contract as YOLO and
SCRFD, so it composes with the sliced pipeline unchanged. As in the JAX
package, ``tile_forward`` scales both box axes by the tile **height**,
returns the raw top-k scores without NMS (set predictions) and zero
keypoints. The video and webcam modes of ``FaceDetector`` are not yet
ported.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from facedet_tpu_torch.core.detections import Detections, take_rows
from facedet_tpu_torch.engine.detector import DetectionModel, _exact_float32
from facedet_tpu_torch.models.rtdetr import RTDETR_VARIANTS, RtDetr, decode_rtdetr


class RtDetrDetectionModel(DetectionModel):
    def __init__(self, *args, variant: str = "rtdetr-l", dtype: str = "bfloat16", seed: int = 0, **kwargs):
        self.variant = variant
        self.dtype = dtype
        self.seed = seed
        super().__init__(*args, **kwargs)

    def load_model(self) -> None:
        from facedet_tpu_torch.models.from_jax import load_jax_variables, load_params_npz
        from facedet_tpu_torch.models.init import random_init

        cfg = RTDETR_VARIANTS[self.variant]
        self.cfg = dataclasses.replace(cfg, dtype=self.dtype, num_classes=len(self.category_mapping))
        model = RtDetr(self.cfg)
        if self.model_path is None:
            random_init(model, self.seed)
        elif str(self.model_path).endswith(".npz"):
            tree = load_params_npz(self.model_path)
            # checkpoints from before the denoising table existed lack
            # dn_embed; inference never reads it, so zeros of the right shape
            # stand in. A missing "params" fails here.
            params = tree["params"]
            if "dn_embed" not in params:
                params["dn_embed"] = np.zeros((self.cfg.num_classes + 1, self.cfg.hidden_dim), np.float32)
            load_jax_variables(model, tree)
        else:
            raise ValueError(f"unsupported checkpoint format: {self.model_path}")
        self.model = model.set_dtypes().to(self.device).eval()

    def tile_forward_nchw(self, tiles: torch.Tensor, conf_threshold: float) -> Detections:
        with torch.inference_mode(), _exact_float32(self.dtype == "float32"):
            outs = self.model.forward_nchw(tiles)
            preds = decode_rtdetr(outs, image_size=tiles.shape[2])
            # DETR: set predictions, no NMS; top-k by score with a validity
            # mask. A stable descending sort breaks ties toward the lower
            # index, as lax.top_k does.
            boxes, scores = preds["boxes"], preds["scores"]
            best, cls = scores.max(dim=-1)
            k = min(self.max_detections_per_tile, boxes.shape[1])
            top_val, top_idx = torch.sort(best, dim=1, descending=True, stable=True)
            top_val, top_idx = top_val[:, :k], top_idx[:, :k]
            return Detections(
                boxes=take_rows(boxes, top_idx),
                scores=top_val,
                classes=take_rows(cls, top_idx).to(torch.int32),
                kpts=torch.zeros((boxes.shape[0], k, 5, 3), dtype=torch.float32, device=boxes.device),
                valid=top_val >= conf_threshold,
            )


class FaceDetector:
    """Inference facade over an RT-DETR checkpoint: image and folder modes.
    The video and webcam modes need the video reader, which is not yet
    ported."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        variant: str = "rtdetr-l",
        conf: float = 0.5,
        image_size: int = 640,
        device=None,
    ):
        self.model = RtDetrDetectionModel(
            model_path=model_path,
            variant=variant,
            confidence_threshold=conf,
            image_size=image_size,
            device=device,
        )

    def detect_image(self, image_path: str, output_path: Optional[str] = None):
        from facedet_tpu_torch.engine.predict import get_prediction
        from facedet_tpu_torch.utils.viz import draw_detections_on_image, load_image, save_image

        image = load_image(image_path)
        result = get_prediction(image, self.model)
        if output_path:
            save_image(output_path, draw_detections_on_image(image, result.object_prediction_list))
        return result

    def detect_folder(self, input_dir: str, output_dir: str) -> list:
        os.makedirs(output_dir, exist_ok=True)
        results = []
        for fname in sorted(os.listdir(input_dir)):
            if not fname.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                continue
            results.append(self.detect_image(os.path.join(input_dir, fname), os.path.join(output_dir, fname)))
        return results

    def detect_video(self, video_path: str, output_path: str, frame_skip: int = 0, verbose: bool = True) -> dict:
        raise NotImplementedError("video detection is not yet ported to facedet_tpu_torch")

    def detect_webcam(self, device: str = "/dev/video0", max_frames: int = 0):
        raise NotImplementedError("webcam detection is not yet ported to facedet_tpu_torch")
