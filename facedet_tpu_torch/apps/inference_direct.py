"""Direct single-shot detection baseline, no slicing (counterpart of
facedet_tpu/apps/inference_direct.py): one letterboxed full-image forward.

    python -m facedet_tpu_torch.apps.inference_direct --input photo.jpg \\
        --model-path facedet_tpu/eval/assets/yolo11n_golden.npz --scale n --device cuda
"""
from __future__ import annotations


def main(argv=None):
    from facedet_tpu_torch.apps.common import base_parser, build_detector
    from facedet_tpu_torch.engine.predict import get_prediction
    from facedet_tpu_torch.utils.config import DetectorConfig
    from facedet_tpu_torch.utils.viz import load_image

    ap = base_parser("Direct (non-sliced) face detection baseline (PyTorch)")
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
    result = get_prediction(load_image(args.input), model)
    for p in result.object_prediction_list:
        print(f"face conf={p.score.value:.3f} bbox={p.bbox.to_xyxy()}")
    print(f"{len(result.object_prediction_list)} faces")
    return result


if __name__ == "__main__":
    main()
