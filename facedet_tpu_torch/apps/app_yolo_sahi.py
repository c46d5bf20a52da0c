"""Batch SAHI face-detection CLI (counterpart of
facedet_tpu/apps/app_yolo_sahi.py): loops the input folder, runs sliced
prediction per image, and writes a per-image folder with the annotated
image, face crops and a text summary.

    python -m facedet_tpu_torch.apps.app_yolo_sahi --input imgs/ --output out/ \\
        --model-path facedet_tpu/eval/assets/yolo11n_golden.npz --scale n --device cuda
"""
from __future__ import annotations

import os
import time


def process_single_image(
    image_path: str,
    detection_model,
    output_root: str,
    slice_size: int = 640,
    overlap: float = 0.2,
    postprocess_match_threshold: float = 0.5,
    ingest: str = "rgb",
) -> dict:
    """One image -> output folder.

    ``ingest`` picks the host-to-device upload format: "yuv420" decodes the
    file to planar YUV (1.5 bytes a pixel), "dct420" / "dct420s" read a
    JPEG's own quantized coefficients, dense or as the sparse wire; the
    device does the rest of the decode."""
    from facedet_tpu_torch.engine.predict import get_sliced_prediction
    from facedet_tpu_torch.utils.viz import (
        create_detection_summary,
        draw_detections_on_image,
        load_image,
        save_face_crops,
        save_image,
    )

    name = os.path.splitext(os.path.basename(image_path))[0]
    out_dir = os.path.join(output_root, name)
    os.makedirs(out_dir, exist_ok=True)
    if ingest == "yuv420":
        from facedet_tpu_torch.data.native_loader import load_image_yuv420

        image = load_image_yuv420(image_path)
    elif ingest in ("dct420", "dct420s"):
        from facedet_tpu_torch.data.native_loader import load_image_dct420

        image = load_image_dct420(image_path)
    else:
        image = load_image(image_path)
    t0 = time.perf_counter()
    result = get_sliced_prediction(
        image,
        detection_model,
        slice_height=slice_size,
        slice_width=slice_size,
        overlap_height_ratio=overlap,
        overlap_width_ratio=overlap,
        postprocess_type="GREEDYNMM",
        postprocess_match_metric="IOS",
        postprocess_match_threshold=postprocess_match_threshold,
        postprocess_class_agnostic=True,
        input_format=ingest,
    )
    elapsed = time.perf_counter() - t0
    preds = result.object_prediction_list
    image = result.image  # RGB view (reconstructed for yuv/dct ingest)
    vis = draw_detections_on_image(image, preds)
    save_image(os.path.join(out_dir, f"{name}_detections.jpg"), vis)
    crops = save_face_crops(image, preds, os.path.join(out_dir, "crops"), prefix=f"{name}_face")
    create_detection_summary(
        preds,
        image_name=os.path.basename(image_path),
        output_path=os.path.join(out_dir, f"{name}_summary.txt"),
        extra_info={
            "pipeline": f"SAHI {slice_size}x{slice_size} overlap {overlap}",
            "elapsed_seconds": f"{elapsed:.3f}",
        },
    )
    return {"image": image_path, "faces": len(preds), "crops": len(crops), "seconds": elapsed}


def main(argv=None):
    from facedet_tpu_torch.apps.common import base_parser, build_detector, list_inputs
    from facedet_tpu_torch.utils.config import DetectorConfig

    ap = base_parser("YOLOv11 + SAHI batch face detection (PyTorch)")
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
    stats = []
    for path in inputs:
        s = process_single_image(path, model, args.output, args.slice, args.overlap, ingest=args.ingest)
        print(f"{s['image']}: {s['faces']} faces in {s['seconds']:.2f}s")
        stats.append(s)
    total = sum(s["faces"] for s in stats)
    print(f"Done: {len(stats)} images, {total} faces -> {args.output}")
    return stats


if __name__ == "__main__":
    main()
