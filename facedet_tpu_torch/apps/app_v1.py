"""Pipeline v1 CLI: detect first, then enhance the face crops (counterpart
of facedet_tpu/apps/app_v1.py): adaptive half-image slicing for small
inputs, SAHI detection, annotated output and face crops, then Real-ESRGAN
over the crops directory with a summary report.

    python -m facedet_tpu_torch.apps.app_v1 --input imgs/ --output out/ \\
        --model-path facedet_tpu/eval/assets/yolo11n_golden.npz --scale n --device cuda
"""
from __future__ import annotations

import os


def main(argv=None):
    from facedet_tpu_torch.apps.common import base_parser, build_detector, build_enhancer, list_inputs
    from facedet_tpu_torch.engine.enhancer import create_enhancement_summary
    from facedet_tpu_torch.engine.pipelines import detect_first_pipeline
    from facedet_tpu_torch.utils.config import DetectorConfig, EnhancerConfig
    from facedet_tpu_torch.utils.viz import draw_detections_on_image, load_image, save_image

    ap = base_parser("Detect-first pipeline: SAHI detection + crop enhancement (PyTorch)")
    ap.add_argument("--outscale", type=float, default=4.0)
    ap.add_argument("--no-enhance", action="store_true")
    args = ap.parse_args(argv)
    inputs = list_inputs(args.input)
    model = build_detector(
        DetectorConfig(
            family=args.family,
            variant=args.variant,
            scale=args.scale,
            model_path=args.model_path,
            confidence_threshold=args.conf,
            image_size=args.imgsz,
        ),
        device=args.device,
    )
    enhancer = None if args.no_enhance else build_enhancer(EnhancerConfig(outscale=args.outscale), device=args.device)
    out = []
    for path in inputs:
        name = os.path.splitext(os.path.basename(path))[0]
        out_dir = os.path.join(args.output, name)
        image = load_image(path)
        result, stats = detect_first_pipeline(
            image,
            model,
            enhancer=enhancer,
            slice_policy="half_image",
            crops_dir=os.path.join(out_dir, "crops"),
            output_dir=os.path.join(out_dir, "crops_enhanced"),
        )
        save_image(
            os.path.join(out_dir, f"{name}_detections.jpg"),
            draw_detections_on_image(image, result.object_prediction_list),
        )
        if enhancer is not None:
            create_enhancement_summary(
                stats,
                output_path=os.path.join(out_dir, "enhancement_summary.txt"),
                model_info=enhancer.get_model_info(),
            )
        print(
            f"{name}: {len(result.object_prediction_list)} faces, "
            f"enhanced {stats.get('enhanced', 0)}/{stats.get('total', 0)} crops"
        )
        out.append({"image": path, "faces": len(result.object_prediction_list), **stats})
    return out


if __name__ == "__main__":
    main()
