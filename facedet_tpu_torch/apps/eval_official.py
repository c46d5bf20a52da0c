"""Official WIDERFACE evaluation CLI (counterpart of
facedet_tpu/apps/eval_official.py).

Reference: eval/eval_official_widerface.py:500-541 — argparse over the four
modes (standard / sahi uniform / sahi adaptive, each ± enhance ± bounded).

    python -m facedet_tpu_torch.apps.eval_official --images WIDER_val/images \\
        --gt-txt wider_face_val_bbx_gt.txt --scale n \\
        --model-path facedet_tpu/eval/assets/yolo11n_golden.npz --device cuda
"""
from __future__ import annotations

import argparse


def main(argv=None):
    from facedet_tpu_torch.apps.common import build_detector, build_enhancer
    from facedet_tpu_torch.eval.widerface_official import OfficialWiderFaceEvaluator
    from facedet_tpu_torch.utils.config import DetectorConfig, EnhancerConfig

    ap = argparse.ArgumentParser(description="Official WIDERFACE Easy/Medium/Hard evaluation (PyTorch)")
    ap.add_argument("--images", required=True, help="WIDER_val/images root")
    ap.add_argument("--gt-mat", default=None, help="dir with wider_face_val.mat etc.")
    ap.add_argument("--gt-txt", default=None, help="wider_face_val_bbx_gt.txt (no-scipy path)")
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--family", default="yolov11", choices=["yolov11", "scrfd", "rtdetr", "fake"])
    ap.add_argument("--scale", default="s")
    ap.add_argument("--no-sahi", action="store_true")
    ap.add_argument("--slicing", default="uniform", choices=["uniform", "adaptive"])
    ap.add_argument("--slice", type=int, default=640)
    ap.add_argument("--overlap", type=float, default=0.2)
    ap.add_argument("--no-standard-pred", action="store_true",
                    help="disable the full-image pass fused into SAHI merges")
    ap.add_argument("--enhance", action="store_true")
    ap.add_argument("--bounded", action="store_true", help="bounded enhancement gate")
    ap.add_argument("--conf", type=float, default=0.01)
    ap.add_argument("--output", default="output")
    ap.add_argument(
        "--ingest", default="rgb",
        choices=["rgb", "yuv420", "dct420", "dct420s"],
        help="upload format for the eval stream (non-rgb needs SAHI mode and no enhancer)",
    )
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    model = build_detector(
        DetectorConfig(
            family=args.family,
            scale=args.scale,
            model_path=args.model_path,
            confidence_threshold=args.conf,
            image_size=1024,
        ),
        device=args.device,
    )
    enhancer = build_enhancer(EnhancerConfig(outscale=4.0), device=args.device) if args.enhance else None
    evaluator = OfficialWiderFaceEvaluator(
        model,
        images_path=args.images,
        gt_path=args.gt_mat,
        gt_txt=args.gt_txt,
        use_sahi=not args.no_sahi,
        slicing_strategy=args.slicing,
        sahi_config={
            "slice_height": args.slice,
            "slice_width": args.slice,
            "overlap_ratio": args.overlap,
        },
        enhancer=enhancer,
        perform_standard_pred=not args.no_standard_pred,
        bounded_enhancement=args.bounded,
        inference_confidence=args.conf,
        output_dir=args.output,
        ingest=args.ingest,
    )
    results = evaluator.run()
    print(f"Mode: {results['mode']}")
    for setting, ap_value in results["aps"].items():
        print(f"  AP {setting}: {ap_value:.4f}")
    if "images_per_second" in results:
        print(f"  throughput: {results['images_per_second']:.3f} images/s")
    return results


if __name__ == "__main__":
    main()
