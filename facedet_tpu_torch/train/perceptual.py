"""LPIPS-style perceptual loss from the golden YOLO backbone.

Counterpart of facedet_tpu/train/perceptual.py: the golden yolo11n
backbone (eval/assets/yolo11n_golden.npz), float32, eval-mode BatchNorm,
its parameters frozen so that gradients flow through the activations only,
gives features at ``stem`` (P1/2), ``c3k2_0`` (P2/4), ``c3k2_1`` (P3/8) and
``c3k2_2`` (P4/16); each is unit-normalised over the channels with
``rsqrt(sum + 1e-6)``, and the loss is the mean over layers of the mean
squared difference (Zhang et al. 2018's deep-feature distance, a
face-trained backbone in place of VGG).
"""
from __future__ import annotations

import os
from typing import Callable, Sequence

import torch

__all__ = ["make_yolo_feature_loss", "DEFAULT_LAYERS", "GOLDEN_YOLO"]

DEFAULT_LAYERS = ("stem", "c3k2_0", "c3k2_1", "c3k2_2")

GOLDEN_YOLO = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz",
)


def _unit_norm(f: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return f * torch.rsqrt((f * f).sum(dim=1, keepdim=True) + eps)


def make_yolo_feature_loss(
    weights_path: str = GOLDEN_YOLO,
    scale: str = "n",
    layers: Sequence[str] = DEFAULT_LAYERS,
    device=None,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Returns ``loss(a, b) -> scalar`` for images [B,H,W,3] in [0,1] (H and
    W divisible by 32), the backbone on ``device`` (None: the card; raises
    without one unless ``device="cpu"``)."""
    from facedet_tpu_torch.engine.detector import resolve_device
    from facedet_tpu_torch.models.from_jax import load_jax_variables, load_params_npz
    from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11

    model = YoloV11(YoloConfig(scale=scale, num_classes=1, with_pose=True, dtype="float32"))
    load_jax_variables(model, load_params_npz(weights_path))
    backbone = model.backbone.to(resolve_device(device)).eval().requires_grad_(False)
    layers = tuple(layers)

    def loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = backbone.features(a.float().permute(0, 3, 1, 2), layers)
        fb = backbone.features(b.float().permute(0, 3, 1, 2), layers)
        terms = [torch.mean(torch.square(_unit_norm(x) - _unit_norm(y))) for x, y in zip(fa, fb)]
        return torch.stack(terms).mean()

    return loss
