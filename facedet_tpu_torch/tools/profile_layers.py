"""Per-layer bisect of the YOLOv11 forward on the card.

Counterpart of facedet_tpu/tools/profile_layers.py. Each row runs a prefix
of the model's forward up to a step (``STEPS``, the JAX tool's names), made
of the model's own submodules: the backbone's ``features`` up to a stage,
the neck's ``steps``, then the head branch by branch. The weights are the
model's own, so no renaming is needed, and a prefix times what is served:
the config's conv dtype and BatchNorm output dtype. (The JAX tool's
``TruncatedYolo`` rebuilds the layers without ``bn_dtype`` and without the
space-to-depth stem, so for the bfloat16 serving model it times float32
BatchNorms and the standard stack: ROADMAP.md §3.) A step's cost is the
difference between consecutive rows; each row gives wall ms, device ms and
launches per tile (``utils.profiling.device_time``).

Run on the card: python -m facedet_tpu_torch.tools.profile_layers
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

BACKBONE_STEPS = [
    "stem", "down1", "c3k2_0", "down2", "c3k2_1", "down3", "c3k2_2",
    "down4", "c3k2_3", "sppf", "c2psa",
]
NECK_STEPS = ["up0", "up1", "pan_down0", "pan0", "pan_down1", "pan1"]
HEAD_STEPS = ["head_box", "head_cls", "head_kpt"]
STEPS = [f"backbone/{s}" for s in BACKBONE_STEPS] + [f"neck/{s}" for s in NECK_STEPS] + HEAD_STEPS
_HEAD_BRANCHES = {"head_box": ("box",), "head_cls": ("box", "cls"), "head_kpt": ("box", "cls", "kpt")}


def truncated_forward(model, x: torch.Tensor, stop_at: str) -> list[torch.Tensor]:
    """``model`` (a ``YoloV11``) on NCHW tiles ``x``, stopped after
    ``stop_at``: a backbone or neck step gives ``[its output]`` (NCHW), a
    head step the outputs of its branches, level by level (box, cls, kpt;
    NHWC float32, as ``DetectHead`` returns them): the list the JAX tool's
    ``TruncatedYolo`` returns, in the port's layouts."""
    if stop_at not in STEPS:
        raise ValueError(f"unknown step {stop_at!r}; expected one of {STEPS}")
    section, _, step = stop_at.partition("/")
    x = x.to(model.cfg.compute_dtype)
    if section == "backbone":
        return model.backbone.features(x, (step,))
    feats = model.backbone(x)
    if section == "neck":
        return [next(out for name, out in model.neck.steps(feats) if name == step)]
    head = model.head
    outs = []
    for i, f in enumerate(model.neck(feats)):
        for branch, names in head.branches(i).items():
            if branch in _HEAD_BRANCHES[stop_at]:
                outs.append(head._branch(names, f))
    return outs


def main(tiles: int = 42, size: int = 640, device: str = "cuda", iters: int = 10, profile_iters: int = 3) -> dict:
    """yolo11s-pose (seeded), bfloat16, ``tiles`` random tiles of
    ``size``²: every step's row per tile. Returns ``{"rows": {step: row},
    "marginal": {step: device ms per tile (wall ms on the CPU)}}``."""
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel, resolve_device
    from facedet_tpu_torch.utils.profiling import device_time, format_row, marginal, per_unit, tree_sum

    dev = resolve_device(device)
    model = YoloV11PoseDetectionModel(scale="s", dtype="bfloat16", confidence_threshold=0.25, image_size=size,
                                      max_detections_per_tile=300, device=dev).model
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((tiles, size, size, 3), np.float32)).permute(0, 3, 1, 2).to(dev)
    rows = {}
    with torch.inference_mode():
        for stop in STEPS:
            fn = lambda t, stop=stop: tree_sum(truncated_forward(model, t, stop))  # noqa: E731
            rows[stop] = per_unit(device_time(fn, x, iters=iters, profile_iters=profile_iters), tiles)
            print(format_row(f"{stop} (cumulative)", rows[stop], "tile"), flush=True)
    key, cost = marginal(rows)
    print(f"\n-- marginal {key.replace('_', ' ')} per tile")
    for stop, ms in cost.items():
        print(f"{stop:20s} {ms:8.4f}")
    return {"rows": rows, "marginal": cost}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, default=42)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card; cpu runs without one)")
    args = ap.parse_args()
    main(tiles=args.tiles, device=args.device)
