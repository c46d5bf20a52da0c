"""Pipeline v2 CLI: enhance first, detect on the enhanced image, map back
(counterpart of facedet_tpu/apps/app_v2.py): 3x3 / 4x4 grid slicing rounded
to x64, whole-image Real-ESRGAN, SAHI detection on the enhanced image, boxes
divided by the scale factor and drawn on the original.

    python -m facedet_tpu_torch.apps.app_v2 --input imgs/ --output out/ --outscale 4 \\
        --model-path facedet_tpu/eval/assets/yolo11n_golden.npz --scale n --device cuda
"""
from __future__ import annotations

import os


def main(argv=None):
    from facedet_tpu_torch.apps.common import base_parser, build_detector, build_enhancer, list_inputs
    from facedet_tpu_torch.engine.pipelines import enhance_first_pipeline
    from facedet_tpu_torch.utils.config import DetectorConfig, EnhancerConfig
    from facedet_tpu_torch.utils.viz import draw_detections_on_image, load_image, save_image

    ap = base_parser("Enhance-first pipeline: full-image SR then SAHI detection (PyTorch)")
    ap.add_argument("--outscale", type=float, default=4.0)
    args = ap.parse_args(argv)
    inputs = list_inputs(args.input)
    model = build_detector(
        DetectorConfig(
            family=args.family,
            scale=args.scale,
            model_path=args.model_path,
            confidence_threshold=args.conf,
            image_size=args.imgsz,
        ),
        device=args.device,
    )
    enhancer = build_enhancer(EnhancerConfig(outscale=args.outscale), device=args.device)
    out = []
    for path in inputs:
        name = os.path.splitext(os.path.basename(path))[0]
        image = load_image(path)
        result = enhance_first_pipeline(image, model, enhancer, slice_policy="fixed_grid")
        out_dir = os.path.join(args.output, name)
        save_image(
            os.path.join(out_dir, f"{name}_detections.jpg"),
            draw_detections_on_image(image, result.object_prediction_list),
        )
        save_image(os.path.join(out_dir, f"{name}_enhanced.jpg"), result.enhanced_image)
        print(
            f"{name}: {len(result.object_prediction_list)} faces "
            f"(enhance {result.durations_in_seconds.get('enhance', 0):.2f}s)"
        )
        out.append({"image": path, "faces": len(result.object_prediction_list)})
    return out


if __name__ == "__main__":
    main()
