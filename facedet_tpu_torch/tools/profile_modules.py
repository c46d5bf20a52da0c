"""Module-level profile of the YOLO tile forward on the card.

Counterpart of facedet_tpu/tools/profile_modules.py: the backbone, the PAN
neck, the head with its pose branch and without it, and ``DenseClsHead``
(the cls branch with its depthwise pair replaced by one dense 3x3
``ConvBnAct`` per level, same channels) as an A/B of the depthwise convs.
Timing only: every module has seeded random weights; no accuracy claim.
Each row gives wall ms, device ms and launches per call of the whole tile
batch (``utils.profiling.device_time``), and the backbone and neck per image
of 6 tiles.

Run on the card: python -m facedet_tpu_torch.tools.profile_modules
(the JAX tool's docstring names ``profile_layers`` as its command; this is
the module's own, ROADMAP.md §3).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from facedet_tpu_torch.models.layers import ConvBnAct


class DenseClsHead(nn.Module):
    """The cls branch with ONE dense 3x3 ``ConvBnAct`` per level (same in and
    out channels, bfloat16 conv and BatchNorm output) then a 1x1 conv to one
    class, flax's names ``cls{i}_dense`` / ``cls{i}_out``: isolates the cost
    of the depthwise convs. Returns per level [B, H, W, 1] float32."""

    def __init__(self, chans: tuple[int, ...]):
        super().__init__()
        for i, c in enumerate(chans):
            setattr(self, f"cls{i}_dense", ConvBnAct(c, c, 3))
            setattr(self, f"cls{i}_out", nn.Conv2d(c, 1, 1))

    def set_dtypes(self) -> "DenseClsHead":
        """bfloat16 convs and BatchNorm outputs, as the JAX class fixes them."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(torch.bfloat16)
            elif isinstance(m, ConvBnAct):
                m.bn_dtype = torch.bfloat16
        return self

    def forward(self, feats):
        outs = []
        for i, f in enumerate(feats):
            x = getattr(self, f"cls{i}_dense")(f)
            out = getattr(self, f"cls{i}_out")
            outs.append(out(x.to(out.weight.dtype)).float().permute(0, 2, 3, 1))
        return outs


def main(n_tiles: int = 48, device: str = "cuda", iters: int = 10, profile_iters: int = 3) -> dict:
    """yolo11s-pose sections in bfloat16 (convs and BatchNorm output) on a
    batch of ``n_tiles`` 640x640 tiles. Returns ``{"rows": {label: row per
    call}, "per_image": {"backbone": ms, "neck": ms}}`` (device ms per image
    of 6 tiles; wall ms on the CPU)."""
    from facedet_tpu_torch.engine.detector import resolve_device
    from facedet_tpu_torch.models.init import random_init
    from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11
    from facedet_tpu_torch.utils.profiling import device_time, format_row, tree_sum

    dev = resolve_device(device)
    nets = {}
    for pose in (True, False):
        net = YoloV11(YoloConfig(scale="s", dtype="bfloat16", bn_dtype="bfloat16", with_pose=pose))
        random_init(net, 0)
        nets[pose] = net.set_dtypes().to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(0).random((n_tiles, 3, 640, 640), np.float32)).to(dev, torch.bfloat16)
    rows = {}

    def timed(label, fn, *args):
        rows[label] = device_time(lambda *a: tree_sum(fn(*a)), *args, iters=iters, profile_iters=profile_iters)
        print(format_row(label, rows[label], "call"), flush=True)

    with torch.inference_mode():
        net = nets[True]
        feats = net.backbone(x)
        print(f"tile batch [{n_tiles},3,640,640]; feature shapes {[tuple(f.shape) for f in feats]}")
        timed("backbone (full)", net.backbone, x)
        timed("neck (PAN)", net.neck, feats)
        nfeats = net.neck(feats)
        timed("head (pose)", nets[True].head, nfeats)
        timed("head (no pose)", nets[False].head, nfeats)
        dense = DenseClsHead(tuple(f.shape[1] for f in nfeats))
        random_init(dense, 0)
        timed("cls-only dense 3x3 (A/B)", dense.set_dtypes().to(dev).eval(), nfeats)
    key = "wall_ms" if rows["neck (PAN)"]["device_ms"] is None else "device_ms"
    per_image = {k: rows[label][key] / n_tiles * 6 for k, label in (("backbone", "backbone (full)"),
                                                                    ("neck", "neck (PAN)"))}
    print(f"\nper image (6 tiles, {key.replace('_', ' ')}): backbone {per_image['backbone']:.2f} "
          f"neck {per_image['neck']:.2f} ms")
    return {"rows": rows, "per_image": per_image}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-tiles", type=int, default=48)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card; cpu runs without one)")
    args = ap.parse_args()
    main(n_tiles=args.n_tiles, device=args.device)
