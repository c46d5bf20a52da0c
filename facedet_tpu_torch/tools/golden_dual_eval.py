"""Run the dual evaluator and the SAHI grid-search tuner on REAL photos.

Both apparatuses were previously exercised only by synthetic tests
(VERDICT r4 missing #3 / weak #5); this tool scores actual photographs —
the reference-golden WIDERFACE images — with the committed golden
checkpoint, and commits the artifacts the reference itself commits:

* dual evaluator — 6-subcategory + reconstructed Easy/Medium/Hard table
  across the 4 pipeline modes (baseline / SAHI / bounded-enhance /
  bounded-enhance+SAHI), JSON + 3-panel bar chart
  (reference: eval/eval_dual.py:560-682);
* tuner — quick-grid search over the golden COCO set producing
  ``sahi_tuning_complete_results.json`` + ``best_sahi_config.json``, and a
  consumption check through ``load_best_sahi_config``
  (reference: utils/tuning_sahi.py:272-288).

Subcategory ground truth is built from the recovered reference detections:
sizes come from the recovered boxes; the degraded flag is a
variance-of-Laplacian blur heuristic on each face crop (the recovered
goldens carry no blur/occlusion/pose attributes — documented in the
artifact). Low-confidence recovered faces are written invalid=1 and act as
the official ignore list, exactly like tools/golden_official_eval.py.

Run: python -m facedet_tpu_torch.tools.golden_dual_eval --ref-dir <reference
checkout> [--tune] [--device cuda]

Counterpart of facedet_tpu/tools/golden_dual_eval.py over the port's
evaluators. Its outputs go under ``--work-dir`` (runs/golden_dual_eval/);
``--commit`` copies them into facedet_tpu_torch/eval/assets/, never into the
JAX package's assets.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from facedet_tpu_torch.tools.golden_finetune import _ASSETS, GOLDENS_PATH, PORT_ASSETS, REF_DIR
from facedet_tpu_torch.tools.golden_official_eval import build_widerface_layout

__all__ = [
    "BLUR_VAR_THRESHOLD",
    "laplacian_blur_flag",
    "build_golden_subcategory_gt",
    "run_dual",
    "run_tuner",
    "main",
]

# variance-of-Laplacian threshold: crops sharper than this read as "clear".
# Calibrated on the golden crops so both flags occur (see committed stats).
BLUR_VAR_THRESHOLD = 100.0


def laplacian_blur_flag(image_u8: np.ndarray, bbox_xyxy,
                        threshold: float = BLUR_VAR_THRESHOLD) -> int:
    """1 if the face crop looks blurred (low variance of the Laplacian).

    The recovered goldens have no WIDERFACE attribute columns, so the dual
    evaluator's ``degraded`` axis is reconstructed with the standard
    sharpness heuristic: var(lap(gray crop)) < threshold -> blur=1. Crops
    too small to resolve (< 8 px a side) count as blurred — they cannot
    carry facial detail."""
    x1, y1, x2, y2 = (int(round(v)) for v in bbox_xyxy)
    h, w = image_u8.shape[:2]
    x1, x2 = max(0, x1), min(w, x2)
    y1, y2 = max(0, y1), min(h, y2)
    if x2 - x1 < 8 or y2 - y1 < 8:
        return 1
    crop = image_u8[y1:y2, x1:x2].astype(np.float32)
    gray = crop @ np.array([0.299, 0.587, 0.114], np.float32)
    lap = (
        -4.0 * gray[1:-1, 1:-1]
        + gray[:-2, 1:-1] + gray[2:, 1:-1] + gray[1:-1, :-2] + gray[1:-1, 2:]
    )
    return int(float(lap.var()) < threshold)


def build_golden_subcategory_gt(goldens: dict, ref_dir: str, work_dir: str,
                                min_conf: float = 0.2) -> tuple[str, dict, dict]:
    """Golden images -> WIDERFACE layout with blur flags -> subcategory GT.

    Returns (images_path, subcategory_data, statistics)."""
    from facedet_tpu_torch.eval.subcategory import build_subcategory_gt

    images_path, gt_txt = build_widerface_layout(
        goldens, ref_dir, work_dir, min_conf=min_conf,
        blur_fn=laplacian_blur_flag,
    )
    out_json = os.path.join(work_dir, "subcategory_gt.json")
    res = build_subcategory_gt(gt_txt, output_json=out_json)
    return images_path, res["data"], res["statistics"]


def _make_mode_evaluator(mode: str, model, images_path: str, work_dir: str):
    """One of the reference dual evaluator's 4 pipeline modes
    (eval/eval_dual.py:39-40: use_sahi x use_enhancer); the enhancer runs
    on the detector's device."""
    from facedet_tpu_torch.eval.widerface_official import OfficialWiderFaceEvaluator

    enhancer = None
    if "enhance" in mode:
        from facedet_tpu_torch.engine.enhancer import FaceEnhancer

        # the reference dual eval uses the x2 model (eval/eval_dual.py:123)
        enhancer = FaceEnhancer(model_name="RealESRGAN_x2plus", device=model.device)
    return OfficialWiderFaceEvaluator(
        model,
        images_path,
        gt_txt=None,
        use_sahi=("sahi" in mode),
        sahi_config={"slice_height": 640, "slice_width": 640,
                     "overlap_ratio": 0.25},
        enhancer=enhancer,
        bounded_enhancement=enhancer is not None,
        # reference eval_dual.py:69 — conf 0.01 under SAHI, 0.5 standard;
        # 0.01 everywhere here so the 11-pt AP integrates a full PR curve
        inference_confidence=0.01,
        output_dir=os.path.join(work_dir, mode),
    )


def run_dual(args, model, goldens) -> dict:
    from facedet_tpu_torch.data.native_loader import load_image
    from facedet_tpu_torch.eval.dual import DualWiderFaceEvaluator

    images_path, subcat, stats = build_golden_subcategory_gt(
        goldens, args.ref_dir, args.work_dir, min_conf=args.min_conf
    )
    print("subcategory stats:", json.dumps(stats["per_category"], indent=1))

    modes = [m for m in args.modes.split(",") if m]
    combined = {
        "gt_source": "recovered reference detections (reference_goldens.json)",
        "degraded_flag": f"var(laplacian) < {BLUR_VAR_THRESHOLD} on the crop",
        "checkpoint": args.weights,
        "statistics": stats,
        "modes": {},
    }
    for mode in modes:
        ev = _make_mode_evaluator(mode, model, images_path, args.work_dir)

        def predict_fn(path, _ev=ev):
            return _ev.run_single_inference(load_image(path))

        dual = DualWiderFaceEvaluator(
            predict_fn,
            subcat,
            images_path=images_path,
            output_dir=os.path.join(args.work_dir, mode),
            mode_string=ev.mode_string,
        )
        res = dual.run(save=True)
        combined["modes"][mode] = res
        for row in res["difficulty_results"]:
            print(f"{mode:14s} {row['category']:6s} AP {row['ap']:.3f} "
                  f"P {row['precision']:.3f} R {row['recall']:.3f}")

    out = os.path.join(args.work_dir, "golden_dual_eval.json")
    with open(out, "w") as f:
        json.dump(combined, f, indent=1)
    print(f"wrote {out}")
    if args.commit:
        os.makedirs(PORT_ASSETS, exist_ok=True)
        shutil.copyfile(out, os.path.join(PORT_ASSETS, "golden_dual_eval.json"))
        chart_mode = "sahi" if "sahi" in modes else modes[-1]
        chart = os.path.join(args.work_dir, chart_mode, "dual_eval_chart.png")
        if os.path.exists(chart):
            shutil.copyfile(
                chart, os.path.join(PORT_ASSETS, "golden_dual_eval_chart.png")
            )
        print(f"committed artifacts to {PORT_ASSETS}")
    return combined


def run_tuner(args, model, goldens) -> dict:
    """Quick-grid SAHI search over the golden COCO set + consumption check."""
    from facedet_tpu_torch.data.native_loader import load_image
    from facedet_tpu_torch.eval.tuning import run_grid_search
    from facedet_tpu_torch.utils.config import load_best_sahi_config

    dataset = []
    for i, (name, rec) in enumerate(sorted(goldens["images"].items())):
        src = os.path.join(args.ref_dir, name, "temp_sahi_input.jpg")
        if not os.path.exists(src):
            continue
        gt = [
            [f["bbox"][0], f["bbox"][1],
             f["bbox"][2] - f["bbox"][0], f["bbox"][3] - f["bbox"][1]]
            for f in rec["faces"] if f.get("conf_hi", 1.0) >= args.min_conf
        ]
        dataset.append({"file_name": src, "image_id": i, "gt": gt})
    print(f"tuning over {len(dataset)} golden images, grid={args.grid}")

    out_dir = os.path.join(args.work_dir, "tuning")
    res = run_grid_search(
        model, dataset, load_image, grid_name=args.grid,
        output_dir=out_dir, save=True,
    )
    best_path = os.path.join(out_dir, "best_sahi_config.json")
    sc, pc = load_best_sahi_config(best_path)  # consumption check
    print(f"best config consumable: slice {sc.slice_height} overlap "
          f"{sc.overlap_height_ratio} {pc.postprocess_type}/"
          f"{pc.postprocess_match_metric}@{pc.postprocess_match_threshold}")
    if args.commit:
        os.makedirs(PORT_ASSETS, exist_ok=True)
        shutil.copyfile(
            best_path, os.path.join(PORT_ASSETS, "golden_best_sahi_config.json")
        )
        shutil.copyfile(
            os.path.join(out_dir, "sahi_tuning_complete_results.json"),
            os.path.join(PORT_ASSETS, "golden_tuning_results.json"),
        )
        print(f"committed artifacts to {PORT_ASSETS}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default=os.path.join(_ASSETS, "yolo11n_golden.npz"))
    ap.add_argument("--scale", default="n")
    ap.add_argument("--goldens", default=GOLDENS_PATH)
    ap.add_argument("--ref-dir", default=REF_DIR)
    ap.add_argument("--work-dir", default="runs/golden_dual_eval")
    ap.add_argument("--min-conf", type=float, default=0.2)
    ap.add_argument("--modes", default="baseline,sahi,enhance,enhance_sahi")
    ap.add_argument("--tune", action="store_true",
                    help="also run the quick-grid SAHI tuner")
    ap.add_argument("--tune-only", action="store_true")
    ap.add_argument("--grid", default="quick")
    ap.add_argument("--commit", action="store_true",
                    help="copy artifacts into facedet_tpu_torch/eval/assets/")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs here)")
    args = ap.parse_args(argv)

    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel

    with open(args.goldens) as f:
        goldens = json.load(f)
    model = YoloV11PoseDetectionModel(
        model_path=args.weights, scale=args.scale, dtype="bfloat16",
        bn_dtype="float32",  # match golden_official_eval's reproducibility note
        confidence_threshold=0.25, image_size=640, device=args.device,
    )
    results = {}
    if not args.tune_only:
        results["dual"] = run_dual(args, model, goldens)
    if args.tune or args.tune_only:
        results["tuning"] = run_tuner(args, model, goldens)
    return results


if __name__ == "__main__":
    main()
