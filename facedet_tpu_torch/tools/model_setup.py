"""Model setup: where each published checkpoint comes from, synthetic
sample images, and a post-load smoke inference.

Counterpart of facedet_tpu/tools/model_setup.py (reference
utils/download_models.py:8-67). Nothing is downloaded: a checkpoint is
fetched by hand and converted offline (models/convert.py), and a missing
file raises with those instructions.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["WEIGHT_SOURCES", "ensure_weights", "generate_sample_images", "smoke_test_model"]

WEIGHT_SOURCES = {
    "yolo11s-pose": "ultralytics release asset yolo11s-pose.pt -> YoloV11PoseDetectionModel(model_path=...) "
    "or facedet_tpu_torch.models.convert.convert_ultralytics_checkpoint",
    "RealESRGAN_x4plus": "xinntao/Real-ESRGAN release RealESRGAN_x4plus.pth -> "
    "facedet_tpu_torch.models.convert.convert_rrdbnet_checkpoint",
    "RealESRGAN_x2plus": "xinntao/Real-ESRGAN release RealESRGAN_x2plus.pth -> "
    "facedet_tpu_torch.models.convert.convert_rrdbnet_checkpoint",
    "scrfd_2.5g": "insightface model zoo scrfd_2.5g_bnkps.onnx -> ScrfdDetectionModel(model_path=...)",
}


def ensure_weights(name: str, path: Optional[str]) -> Optional[str]:
    """Return the path if it exists (None means a seeded random init);
    otherwise raise with instructions to fetch and convert offline."""
    if path is None:
        return None
    if os.path.exists(path):
        return path
    hint = WEIGHT_SOURCES.get(name, "obtain the torch checkpoint and convert offline")
    raise FileNotFoundError(
        f"weights for {name!r} not found at {path}. Nothing is downloaded; "
        f"acquire and convert offline: {hint}"
    )


def generate_sample_images(output_dir: str, n: int = 3, size=(480, 640), seed: int = 0) -> list[str]:
    """Synthetic sample images with face-like bright ellipses on a textured
    background (reference utils/download_models.py:30-53), the JAX
    package's generator draw for draw."""
    from facedet_tpu_torch.utils.viz import save_image

    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        img = rng.integers(40, 90, (h, w, 3)).astype(np.float32)
        my, mx = min(60, h // 3), min(60, w // 3)
        for _ in range(rng.integers(2, 6)):
            cy, cx = rng.integers(my, h - my), rng.integers(mx, w - mx)
            ry, rx = rng.integers(18, 40), rng.integers(14, 30)
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            skin = rng.integers(150, 230, (3,))
            img[mask] = skin
            for ex in (-rx // 3, rx // 3):  # eyes
                em = ((yy - (cy - ry // 4)) ** 2 + (xx - (cx + ex)) ** 2) <= 9
                img[em] = 30
        path = os.path.join(output_dir, f"sample_{i}.jpg")
        save_image(path, img.clip(0, 255).astype(np.uint8))
        paths.append(path)
    return paths


def smoke_test_model(detection_model, size=(480, 640)) -> bool:
    """Post-load smoke inference on a random image (reference
    utils/download_models.py:22-25)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (*size, 3), dtype=np.uint8)
    detection_model.perform_inference(img)
    return detection_model.original_predictions is not None
