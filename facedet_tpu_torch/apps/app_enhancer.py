"""Standalone crop-enhancement CLI (counterpart of
facedet_tpu/apps/app_enhancer.py): prints the Real-ESRGAN model catalog and
runs batch crop enhancement over a directory, with a summary report.

    python -m facedet_tpu_torch.apps.app_enhancer --input crops/ --model RealESRGAN_x2plus \\
        --outscale 2 --fetch dct420s --device cuda
"""
from __future__ import annotations

import argparse


def main(argv=None):
    from facedet_tpu_torch.engine.enhancer import (
        FaceEnhancer,
        create_enhancement_summary,
        enhance_face_crops_batch,
        get_available_models,
    )

    ap = argparse.ArgumentParser(description="Batch Real-ESRGAN crop enhancement (PyTorch)")
    ap.add_argument("--input", required=True, help="directory of face crops")
    ap.add_argument("--output", default=None, help="default: <input>_enhanced")
    ap.add_argument("--model", default="RealESRGAN_x4plus")
    ap.add_argument("--model-path", default=None, help=".npz weights of the JAX package")
    ap.add_argument("--outscale", type=float, default=4.0)
    ap.add_argument("--tile", type=int, default=400)
    ap.add_argument("--list-models", action="store_true")
    ap.add_argument(
        "--fetch", default="rgb", choices=["rgb", "dct420", "dct420s"],
        help="result download format: rgb pixels, dct420 = device-encoded "
        "JPEG coefficients entropy-coded natively into the output .jpg, or "
        "dct420s = the same coefficients packed sparse on the device",
    )
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    print("Available models:")
    for name, info in get_available_models().items():
        print(f"  {name}: x{info['scale']}, {info['num_block']} blocks")
    if args.list_models:
        return None

    enhancer = FaceEnhancer(
        model_name=args.model,
        model_path=args.model_path,
        outscale=args.outscale,
        tile=args.tile,
        device=args.device,
    )
    out_dir = args.output or args.input.rstrip("/") + "_enhanced"
    stats = enhance_face_crops_batch(args.input, out_dir, enhancer, fetch=args.fetch)
    report = create_enhancement_summary(
        stats,
        output_path=f"{out_dir}/enhancement_summary.txt",
        model_info=enhancer.get_model_info(),
    )
    print(report)
    return stats


if __name__ == "__main__":
    main()
