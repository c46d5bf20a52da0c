"""Single-image sliced inference CLI with keypoint debug output (counterpart
of facedet_tpu/apps/app_yolo_inference.py): one image, slices of 640 with
overlap 0.2 at conf 0.6, then the annotated image, the crops, a summary and
each face's keypoints printed.

    python -m facedet_tpu_torch.apps.app_yolo_inference --input photo.jpg --output out/ \\
        --model-path facedet_tpu/eval/assets/yolo11n_golden.npz --scale n --device cuda
"""
from __future__ import annotations

import os


def main(argv=None):
    from facedet_tpu_torch.apps.common import base_parser, build_detector
    from facedet_tpu_torch.engine.predict import get_sliced_prediction
    from facedet_tpu_torch.utils.config import DetectorConfig
    from facedet_tpu_torch.utils.viz import (
        KEYPOINT_NAMES,
        create_detection_summary,
        draw_detections_on_image,
        load_image,
        save_face_crops,
        save_image,
    )

    ap = base_parser("Single-image YOLOv11 + SAHI inference (PyTorch)")
    ap.set_defaults(conf=0.6)
    args = ap.parse_args(argv)
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
    path = args.input
    name = os.path.splitext(os.path.basename(path))[0]
    image = load_image(path)
    result = get_sliced_prediction(
        image,
        model,
        slice_height=args.slice,
        slice_width=args.slice,
        overlap_height_ratio=args.overlap,
        overlap_width_ratio=args.overlap,
        postprocess_type="GREEDYNMM",
        postprocess_match_metric="IOS",
        postprocess_match_threshold=0.5,
        postprocess_class_agnostic=True,
        verbose=1,
    )
    preds = result.object_prediction_list
    os.makedirs(args.output, exist_ok=True)
    save_image(os.path.join(args.output, f"{name}_detections.jpg"), draw_detections_on_image(image, preds))
    save_face_crops(image, preds, os.path.join(args.output, "crops"), prefix=f"{name}_face")
    create_detection_summary(preds, image_name=name, output_path=os.path.join(args.output, f"{name}_summary.txt"))
    print(f"{len(preds)} faces detected")
    for i, p in enumerate(preds, 1):
        print(f"Face {i}: conf={p.score.value:.3f} bbox={p.bbox.to_xyxy()}")
        if p.keypoints is not None:
            for kp_name, (x, y, v) in zip(KEYPOINT_NAMES, p.keypoints):
                print(f"  {kp_name}: ({x:.1f}, {y:.1f}) conf={v:.2f}")
    return result


if __name__ == "__main__":
    main()
