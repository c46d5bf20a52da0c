"""Deterministic fake detector backend (counterpart of
facedet_tpu/engine/fake.py).

A synthetic detector, so that the sliced engine, the pipelines and the CLIs
run end to end without model weights. Emits one detection per tile at the
brightest pixel (score = brightness), with keypoints at the same location,
through the same tile contract as the real models.
"""
from __future__ import annotations

import torch

from facedet_tpu_torch.core.detections import Detections
from facedet_tpu_torch.engine.detector import DetectionModel


class FakeBlobDetectionModel(DetectionModel):
    BOX_R = 5.0
    CAPACITY = 4

    def load_model(self):
        self.model = "fake-blob"
        self.variables = {}

    def tile_forward_nchw(self, tiles: torch.Tensor, conf_threshold: float) -> Detections:
        t, _, _, width = tiles.shape
        gray = tiles.to(torch.float32).mean(dim=1).reshape(t, -1)
        score, idx = gray.max(dim=1)  # the first of equal maxima, as jnp.argmax
        y = (idx // width).to(torch.float32)
        x = (idx % width).to(torch.float32)
        r = self.BOX_R
        cap = self.CAPACITY
        det = Detections.empty(cap, device=tiles.device).map(lambda f: f[None].repeat(t, *([1] * f.dim())))
        det.boxes[:, 0] = torch.stack([x - r, y - r, x + r, y + r], dim=-1)
        det.scores[:, 0] = score
        det.kpts[:, 0, :, 0] = x[:, None]
        det.kpts[:, 0, :, 1] = y[:, None]
        det.kpts[:, 0, :, 2] = 1.0
        det.valid[:, 0] = score >= conf_threshold
        return det
