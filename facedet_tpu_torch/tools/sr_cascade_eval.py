"""Evaluate x4 arms built from the trained x2 net: cascade and x2+resize.

Two compositions of the x2 golden net, scored with the same crop set and
IQA table as the x4 reports (tools/sr_golden_train.py helpers), so the x4
arms (L1, GAN, cascade, x2resize) are directly comparable:

* ``--arm cascade`` — the x2 restorer applied twice (x2 ∘ x2);
* ``--arm x2resize`` — one x2 restoration pass + lanczos resize to 4x,
  which is the reference Real-ESRGANer's own semantics when netscale !=
  outscale (utils/enhancer.py:189 resizes the net output to the requested
  outscale).

Reference role: the deployed enhancer config is x4 on face crops
(pipeline_v1_detection_first/app_v1.py:88-106); Real-ESRGANer itself
supports model-scale != outscale, so a composed x4 is a legitimate serving
arm, not a metric trick — fidelity (degrade->restore PSNR on held-out
scenes) is reported alongside.

Run: python -m facedet_tpu_torch.tools.sr_cascade_eval --ref-dir <reference
checkout> [--arm x2resize] [--weights rrdb_x2_golden.npz] [--device cuda]

Counterpart of facedet_tpu/tools/sr_cascade_eval.py: the forward is the
port's ``FaceEnhancer`` net (``_net``: clipped to [0, 1]) and
ops/image.resize_chw's lanczos3 (``jax.image.resize``'s weights). The x2 net
is the committed golden x2 unless ``--weights`` names another checkpoint.
Reports go under runs/sr_cascade_eval/.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from facedet_tpu_torch.tools.golden_finetune import GOLDENS_PATH, REF_DIR
from facedet_tpu_torch.tools.sr_golden_train import (
    collect_face_crops,
    iqa_table,
    load_unique_golden_images,
    save_side_by_side,
)

__all__ = ["make_cascade_forward", "enhance_crops_cascade", "fidelity_cascade", "main"]


def make_cascade_forward(arm: str = "cascade", model_path: str | None = None, device=None):
    """(enhancer, fwd): ``fwd(x [B,3,H,W] in [0,1]) -> [B,3,4H,4W]``, the x2
    net applied twice (``cascade``) or once + lanczos resize to 4x
    (``x2resize``), on the enhancer's device."""
    from facedet_tpu_torch.engine.enhancer import FaceEnhancer
    from facedet_tpu_torch.ops.image import resize_chw

    base = FaceEnhancer(model_name="RealESRGAN_x2plus", model_path=model_path, outscale=2.0, device=device)

    def fwd(x: torch.Tensor) -> torch.Tensor:
        y = base._net(x)
        if arm == "cascade":
            return base._net(y)
        with torch.inference_mode():
            return resize_chw(y, 2 * y.shape[2], 2 * y.shape[3], "lanczos3").clamp_(0.0, 1.0)

    return base, fwd


def _to_u8(x: torch.Tensor) -> np.ndarray:
    """[B,3,H,W] in [0,1] -> [B,H,W,3] uint8 on the host, round to nearest."""
    return (x * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def enhance_crops_cascade(base, fwd, crops: list[np.ndarray]) -> list[np.ndarray]:
    """Bucketed batch enhancement like sr_golden_train.enhance_crops, with
    the pixel budget counting the cascade's 4x mid-tensor (the second pass
    runs at 2x the bucket dims)."""
    buckets: dict[int, list[int]] = {}
    sizes = (96, 192, 384)
    for i, c in enumerate(crops):
        s = max(c.shape[0], c.shape[1])
        b = next((x for x in sizes if s <= x), ((s + 127) // 128) * 128)
        buckets.setdefault(b, []).append(i)
    out: list = [None] * len(crops)
    px_budget = 12 * 420 * 420 // 2
    for b, idxs in sorted(buckets.items()):
        chunk = max(1, min(16, px_budget // (4 * b * b)))  # 2nd pass at 2b
        for c0 in range(0, len(idxs), chunk):
            sel = idxs[c0 : c0 + chunk]
            batch = np.zeros((chunk, b, b, 3), np.float32)
            for j, i in enumerate(sel):
                c = crops[i].astype(np.float32) / 255.0
                h, w = c.shape[:2]
                batch[j] = np.pad(
                    c, ((0, b - h), (0, b - w), (0, 0)), mode="reflect"
                )
            res = _to_u8(fwd(torch.from_numpy(batch).permute(0, 3, 1, 2)))
            for j, i in enumerate(sel):
                h, w = crops[i].shape[:2]
                out[i] = res[j, : h * 4, : w * 4]
    return out


def fidelity_cascade(base, fwd, holdout: list[dict], max_hw: int = 800):
    """Held-out degrade(/4, bicubic) -> cascade-restore PSNR vs bicubic x4."""
    from PIL import Image

    rows = []
    for r in holdout:
        img = r["image"]
        h, w = img.shape[:2]
        s = min(1.0, max_hw / max(h, w))
        hh, ww = (int(h * s) // 8) * 8, (int(w * s) // 8) * 8
        hr = np.asarray(
            Image.fromarray(img).resize((ww, hh), Image.BICUBIC), np.uint8
        )
        lr = np.array(  # a writable copy: torch.from_numpy takes it
            Image.fromarray(hr).resize((ww // 4, hh // 4), Image.BICUBIC),
            np.uint8,
        )
        x = torch.from_numpy(lr).float()[None].permute(0, 3, 1, 2) / 255.0
        restored = _to_u8(fwd(x))[0]
        bic = np.asarray(
            Image.fromarray(lr).resize((ww, hh), Image.BICUBIC), np.uint8
        )

        def psnr(a, b):
            mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
            return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)

        rows.append(
            {
                "image": r["name"],
                "psnr_bicubic": round(psnr(bic, hr), 2),
                "psnr_restored": round(psnr(restored, hr), 2),
            }
        )
        print(f"  {r['name']}: bicubic {rows[-1]['psnr_bicubic']:.2f} dB "
              f"-> cascade {rows[-1]['psnr_restored']:.2f} dB", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-crops", type=int, default=96)
    ap.add_argument("--arm", default="cascade", choices=("cascade", "x2resize"))
    ap.add_argument("--weights", default=None,
                    help="x2 checkpoint (.npz; default: the committed golden x2)")
    ap.add_argument("--report", default=None)
    ap.add_argument("--side-by-side", default=None)
    ap.add_argument("--goldens", default=GOLDENS_PATH)
    ap.add_argument("--ref-dir", default=REF_DIR)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs here)")
    args = ap.parse_args(argv)
    out_dir = os.path.join("runs", "sr_cascade_eval")
    tag = args.arm.replace("x2", "")
    if args.report is None:
        args.report = os.path.join(out_dir, f"sr_x4{tag}_report.json")
    if args.side_by_side is None:
        args.side_by_side = os.path.join(os.path.dirname(args.report), f"sr_x4{tag}_side_by_side.jpg")

    records = load_unique_golden_images(ref_dir=args.ref_dir, goldens=args.goldens)
    order = sorted(range(len(records)), key=lambda i: -records[i]["image"].size)
    hold_idx = set(order[1:4])  # same holdout rule as sr_golden_train
    holdout = [records[i] for i in sorted(hold_idx)]

    base, fwd = make_cascade_forward(args.arm, args.weights, args.device)
    print(f"arm = {args.arm}")
    print("fidelity eval (held-out, degrade -> cascade restore)...")
    fid = fidelity_cascade(base, fwd, holdout)

    crops = collect_face_crops(records, args.max_crops)
    print(f"perceptual eval on {len(crops)} real crops...")
    enhanced = enhance_crops_cascade(base, fwd, [c["crop"] for c in crops])
    table = iqa_table(crops, enhanced)
    print("overall:", json.dumps(table["overall"]))

    report = {
        "arm": (
            "x4 = x2_golden applied twice (cascade)" if args.arm == "cascade"
            else "x4 = x2_golden + lanczos resize (reference netscale!=outscale semantics)"
        ),
        "base_checkpoint": os.path.basename(args.weights) if args.weights else "rrdb_x2_golden.npz",
        "fidelity_holdout": fid,
        "iqa_face_crops": table,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    print(f"report -> {args.report}")
    try:
        save_side_by_side(crops, enhanced, args.side_by_side)
        print(f"side-by-side -> {args.side_by_side}")
    except ValueError as e:  # no crop of 24 px or more to show
        print(f"side-by-side skipped: {e}")
    return report


if __name__ == "__main__":
    main()
