"""Score the committed golden checkpoint through the OFFICIAL WIDERFACE
evaluation protocol on the reference's committed real images.

Builds a WIDERFACE-layout tree (event dir + ``wider_face_*_bbx_gt.txt``-format
ground truth) from the recovered reference goldens, then runs
``OfficialWiderFaceEvaluator`` — the same vectorised 1000-threshold PR / VOC
AP machinery used for the real benchmark (reference:
eval/eval_official_widerface.py:44-541) — in standard and SAHI modes.

"Ground truth" here is the reference pipeline's own detections, so the AP
measures agreement with the reference through the full official protocol
(greedy ignore-aware matching, PR accumulation, AP integration), with real
JPEGs, the native decoder, prefetch, and the fused sliced pipeline all in the
loop.

Run: python -m facedet_tpu_torch.tools.golden_official_eval --ref-dir
<reference checkout> [--device cuda]

Counterpart of facedet_tpu/tools/golden_official_eval.py over the port's
evaluator and detectors; ``build_widerface_layout`` is a copy (the same
files and the same ground-truth text, byte for byte).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

from facedet_tpu_torch.tools.golden_finetune import _ASSETS, GOLDENS_PATH, REF_DIR

EVENT = "golden"

__all__ = ["EVENT", "build_widerface_layout", "main"]


def build_widerface_layout(goldens: dict, ref_dir: str, work_dir: str,
                           min_conf: float = 0.2,
                           blur_fn=None) -> tuple[str, str]:
    """Copy golden source JPEGs into ``<work>/images/golden/`` and write the
    bbx_gt-format ground-truth txt; returns (images_path, gt_txt_path).

    Golden faces whose recorded confidence tops out below ``min_conf`` are
    written with invalid=1 (the official ignore flag): the dense parade dirs
    were produced by a conf-0.01 eval sweep, so most of their "faces" are the
    reference's own sub-threshold dust, not operating-point detections —
    matching them is neither rewarded nor penalised (same filter as
    tools/golden_finetune.py::load_golden_dataset).

    ``blur_fn(image_u8, bbox_xyxy) -> int`` optionally supplies the bbx_gt
    blur attribute per face (the dual evaluator's degraded flag); default 0."""
    images_dir = os.path.join(work_dir, "images", EVENT)
    os.makedirs(images_dir, exist_ok=True)
    lines = []
    n_img = 0
    for name, rec in sorted(goldens["images"].items()):
        src = os.path.join(ref_dir, name, "temp_sahi_input.jpg")
        if not os.path.exists(src):
            continue
        # the full golden key, sanitized: bare rec["source"] stems collide
        # (temp_streamlit/ and temp_streamlit_batch/ share 3 images — same
        # photo, separately recovered detections)
        stem = name.replace("/", "__").replace(" ", "_")
        shutil.copyfile(src, os.path.join(images_dir, f"{stem}.jpg"))
        img = None
        if blur_fn is not None:
            from facedet_tpu_torch.data.native_loader import load_image

            img = load_image(src)
        lines.append(f"{EVENT}/{stem}.jpg")
        lines.append(str(len(rec["faces"])))
        for f in rec["faces"]:
            x1, y1, x2, y2 = f["bbox"]
            # bbx_gt columns: x y w h blur expression illumination invalid
            # occlusion pose — invalid=1 marks ignore regions
            inv = int(float(f.get("conf_hi", 1.0)) < min_conf)
            blur = int(blur_fn(img, f["bbox"])) if blur_fn is not None else 0
            lines.append(f"{x1} {y1} {x2 - x1} {y2 - y1} {blur} 0 0 {inv} 0 0")
        n_img += 1
    gt_txt = os.path.join(work_dir, "golden_bbx_gt.txt")
    with open(gt_txt, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    if not n_img:
        raise SystemExit(f"no golden source images under {ref_dir}")
    return os.path.join(work_dir, "images"), gt_txt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default=os.path.join(_ASSETS, "yolo11n_golden.npz"))
    ap.add_argument("--scale", default="n")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--goldens", default=GOLDENS_PATH)
    ap.add_argument("--ref-dir", default=REF_DIR)
    ap.add_argument("--work-dir", default="runs/golden_official_eval")
    ap.add_argument("--modes", default="standard,sahi",
                    help="comma list of: standard, sahi")
    ap.add_argument("--min-conf", type=float, default=0.2,
                    help="golden faces below this recorded confidence are "
                    "written as invalid=1 (official ignore regions)")
    ap.add_argument("--model", choices=("yolo", "scrfd"), default="yolo",
                    help="detector family; scrfd = the RetinaFace arm "
                    "(reference utils/insightface_wrapper.py:38-60, AP table "
                    "pipeline_v1_detection_first/retinaface_map_scores.txt)")
    ap.add_argument("--variant", default="scrfd_2.5g",
                    help="SCRFD_VARIANTS key for --model scrfd")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs here)")
    args = ap.parse_args(argv)

    from facedet_tpu_torch.eval.widerface_official import OfficialWiderFaceEvaluator

    with open(args.goldens) as f:
        goldens = json.load(f)
    images_path, gt_txt = build_widerface_layout(
        goldens, args.ref_dir, args.work_dir, min_conf=args.min_conf
    )

    if args.model == "scrfd":
        from facedet_tpu_torch.engine.scrfd_wrapper import ScrfdDetectionModel

        model = ScrfdDetectionModel(
            model_path=args.weights, variant=args.variant, dtype="float32",
            confidence_threshold=0.25, image_size=args.imgsz, device=args.device,
        )
    else:
        from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel

        model = YoloV11PoseDetectionModel(
            model_path=args.weights, scale=args.scale, dtype="bfloat16", device=args.device,
            # f32 BN: committed official-eval artifacts stay reproducible
            # across serving-dtype defaults (serving uses bf16 BN)
            bn_dtype="float32",
            confidence_threshold=0.25, image_size=args.imgsz,
        )
    summary = {"weights": args.weights, "model": args.model, "modes": {}}
    for mode in args.modes.split(","):
        ev = OfficialWiderFaceEvaluator(
            model,
            images_path,
            gt_txt=gt_txt,
            use_sahi=(mode == "sahi"),
            sahi_config={"slice_height": 640, "slice_width": 640,
                         "overlap_ratio": 0.25},
            output_dir=os.path.join(args.work_dir, mode),
        )
        res = ev.run()
        summary["modes"][mode] = {
            "aps": res["aps"],
            "images_per_second": res.get("images_per_second"),
        }
        print(mode, json.dumps(summary["modes"][mode]))
    out = os.path.join(args.work_dir, "summary.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {out}")
    return summary


if __name__ == "__main__":
    main()
