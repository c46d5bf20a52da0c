"""Dual (subcategory + difficulty) evaluation CLI (counterpart of
facedet_tpu/apps/eval_dual_cli.py).

Reference: eval/eval_dual.py:685-726 — argparse over the same pipeline modes,
driving the 6-subcategory + Easy/Medium/Hard evaluation from
``subcategory_gt.json``.

    python -m facedet_tpu_torch.apps.eval_dual_cli --images WIDER_val/images \\
        --gt-txt wider_face_val_bbx_gt.txt --scale n \\
        --model-path facedet_tpu/eval/assets/yolo11n_golden.npz --device cuda
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def make_predict_fn(model, enhancer=None, use_sahi: bool = True, slice_size: int = 640,
                    overlap: float = 0.2, perform_standard_pred: bool = True):
    """The CLI's ``predict_fn(image_path) -> [P, 5]`` xywh+score: a PIL
    decode, the optional host enhancement (boxes divided back by its
    outscale), then sliced NMS/IOU 0.5 or the single letterboxed pass."""
    from facedet_tpu_torch.engine.predict import get_prediction, get_sliced_prediction
    from facedet_tpu_torch.utils.viz import load_image

    def predict_fn(img_path: str) -> np.ndarray:
        if not os.path.exists(img_path):
            return np.zeros((0, 5))
        image = load_image(img_path)
        scale = 1.0
        if enhancer is not None:
            image, _ = enhancer.enhance_image(image)
            scale = enhancer.outscale
        if not use_sahi:
            result = get_prediction(image, model)
        else:
            result = get_sliced_prediction(
                image,
                model,
                slice_height=slice_size,
                slice_width=slice_size,
                overlap_height_ratio=overlap,
                overlap_width_ratio=overlap,
                perform_standard_pred=perform_standard_pred,
                postprocess_type="NMS",
                postprocess_match_metric="IOU",
                postprocess_match_threshold=0.5,
                postprocess_class_agnostic=True,
            )
        preds = result.object_prediction_list
        if not preds:
            return np.zeros((0, 5))
        arr = np.array([[*p.bbox.to_xywh(), p.score.value] for p in preds])
        arr[:, :4] /= scale
        return arr

    return predict_fn


def main(argv=None):
    from facedet_tpu_torch.apps.common import build_detector, build_enhancer
    from facedet_tpu_torch.eval.dual import DualWiderFaceEvaluator
    from facedet_tpu_torch.eval.subcategory import build_subcategory_gt
    from facedet_tpu_torch.utils.config import DetectorConfig, EnhancerConfig

    ap = argparse.ArgumentParser(description="Dual WIDERFACE evaluation (6 subcategories + E/M/H, PyTorch)")
    ap.add_argument("--images", required=True)
    ap.add_argument("--subcategory-gt", default=None, help="subcategory_gt.json")
    ap.add_argument("--gt-txt", default=None, help="build subcategory GT from this txt")
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--family", default="yolov11", choices=["yolov11", "scrfd", "rtdetr", "fake"])
    ap.add_argument("--scale", default="s")
    ap.add_argument("--no-sahi", action="store_true")
    ap.add_argument("--slice", type=int, default=640)
    ap.add_argument("--overlap", type=float, default=0.2)
    ap.add_argument("--no-standard-pred", action="store_true",
                    help="disable the full-image pass fused into SAHI merges")
    ap.add_argument("--enhance", action="store_true")
    ap.add_argument("--conf", type=float, default=0.01)
    ap.add_argument("--output", default="output")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.subcategory_gt:
        with open(args.subcategory_gt) as f:
            sub_gt = json.load(f)
    elif args.gt_txt:
        sub_gt = build_subcategory_gt(args.gt_txt)["data"]
    else:
        raise SystemExit("need --subcategory-gt or --gt-txt")

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
    predict_fn = make_predict_fn(model, enhancer, not args.no_sahi, args.slice, args.overlap,
                                 not args.no_standard_pred)

    mode = ("ENHANCE -> " if args.enhance else "") + ("BASELINE" if args.no_sahi else "SAHI")
    evaluator = DualWiderFaceEvaluator(
        predict_fn,
        sub_gt,
        images_path=args.images,
        output_dir=args.output,
        mode_string=mode,
    )
    results = evaluator.run()
    for row in results["subcategory_results"] + results["difficulty_results"]:
        print(
            f"{row['category']:>16}: AP {row['ap']:.4f}  P {row['precision']:.3f} "
            f"R {row['recall']:.3f} F1 {row['f1_score']:.3f} (gt {row['total_gt']})"
        )
    return results


if __name__ == "__main__":
    main()
