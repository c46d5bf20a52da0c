"""Enhance-first YOLO CLI (x2 SR -> SAHI detect on the enhanced image;
counterpart of facedet_tpu/apps/app_yolo_full.py): full-image Real-ESRGAN
x2, sliced detection on the enhanced image, drawing and crops in ENHANCED
coordinates, and a summary annotated with the pipeline info. Unlike app_v2
the outputs stay in the enhanced image's space.

    python -m facedet_tpu_torch.apps.app_yolo_full --input imgs/ --output out/ \\
        --model-path facedet_tpu/eval/assets/yolo11n_golden.npz --scale n --device cuda
"""
from __future__ import annotations

import os
import time


def main(argv=None):
    import torch

    from facedet_tpu_torch.apps.common import base_parser, build_detector, build_enhancer, list_inputs
    from facedet_tpu_torch.engine.enhancer import image_to_device
    from facedet_tpu_torch.engine.predict import get_sliced_prediction
    from facedet_tpu_torch.utils.config import DetectorConfig, EnhancerConfig
    from facedet_tpu_torch.utils.viz import (
        create_detection_summary,
        draw_detections_on_image,
        load_image,
        save_face_crops,
        save_image,
    )

    ap = base_parser("Enhance-first (x2) + SAHI detection, enhanced-coords output (PyTorch)")
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
    enhancer = build_enhancer(EnhancerConfig(model_name="RealESRGAN_x2plus", outscale=2.0), device=args.device)
    out = []
    for path in inputs:
        name = os.path.splitext(os.path.basename(path))[0]
        out_dir = os.path.join(args.output, name)
        image = load_image(path)
        t0 = time.perf_counter()
        # the SR output stays on the device through the sliced detection; the
        # result's display fetch doubles as the host enhanced image for the
        # drawing and the crops (one transfer instead of a fetch and an
        # upload of the canvas)
        enhanced_dev = enhancer.enhance_array(image_to_device(image, enhancer.device))
        if enhanced_dev.is_cuda:
            torch.cuda.synchronize(enhanced_dev.device)  # honest enhance timing
        enhance_dt = time.perf_counter() - t0
        result = get_sliced_prediction(
            enhanced_dev,
            model,
            slice_height=args.slice,
            slice_width=args.slice,
            overlap_height_ratio=args.overlap,
            overlap_width_ratio=args.overlap,
            postprocess_type="GREEDYNMM",
            postprocess_match_metric="IOS",
            postprocess_match_threshold=0.5,
            postprocess_class_agnostic=True,
        )
        preds = result.object_prediction_list
        enhanced = result.image
        save_image(
            os.path.join(out_dir, f"{name}_enhanced_detections.jpg"),
            draw_detections_on_image(enhanced, preds),
        )
        save_face_crops(enhanced, preds, os.path.join(out_dir, "crops"), prefix=f"{name}_face")
        create_detection_summary(
            preds,
            image_name=name,
            output_path=os.path.join(out_dir, f"{name}_summary.txt"),
            extra_info={
                "pipeline": "Real-ESRGAN x2 -> SAHI detection (enhanced coords)",
                "enhance_seconds": f"{enhance_dt:.2f}",
                "total_seconds": f"{time.perf_counter() - t0:.2f}",
            },
        )
        print(f"{name}: {len(preds)} faces on enhanced image")
        out.append({"image": path, "faces": len(preds)})
    return out


if __name__ == "__main__":
    main()
