"""Score this framework's detections against reference-run goldens.

Pairs with tools/reference_goldens.py: the goldens JSON holds the reference
pipeline's actual detections (bbox + conf) on committed real WIDERFACE images
(reference: temp_streamlit/<image>/crops naming, utils/visualization.py:185).
This module runs OUR sliced pipeline on the same source images at the
reference's fixed operating point (slice 640 / overlap 0.25 / IOS 0.5 —
reference: pipeline_v4_yolo/1_Inference.py:563-566) and reports box-level
agreement: the accuracy-parity gate that becomes meaningful the moment
pretrained weights are converted in (models/convert.py, models/onnx_import.py).

Counterpart of facedet_tpu/eval/reference_parity.py over the port's
detector and sliced pipeline; the matching is the same greedy best-IoU
pairing on float32 boxes.

Usage:
    python -m facedet_tpu_torch.eval.reference_parity \
        --goldens facedet_tpu/eval/assets/reference_goldens.json \
        --ref-dir <reference>/temp_streamlit \
        --weights yolo11s-pose.npz [--scale s] [--conf 0.5] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

__all__ = ["match_detections", "compare_image", "run_parity"]

# the reference app's grid-search optimum (1_Inference.py:34,563-566)
REFERENCE_OPERATING_POINT = dict(
    slice_height=640,
    slice_width=640,
    overlap_height_ratio=0.25,
    overlap_width_ratio=0.25,
    postprocess_type="GREEDYNMM",
    postprocess_match_metric="IOS",
    postprocess_match_threshold=0.5,
    perform_standard_pred=True,
)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    from facedet_tpu_torch.core.boxes import iou_matrix

    a = torch.from_numpy(np.asarray(a, np.float32))
    b = torch.from_numpy(np.asarray(b, np.float32))
    return iou_matrix(a, b).numpy()


def match_detections(
    golden_boxes: np.ndarray,
    pred_boxes: np.ndarray,
    iou_thr: float = 0.5,
) -> list[tuple[int, int, float]]:
    """Greedy best-IoU matching; returns (golden_idx, pred_idx, iou) pairs."""
    if len(golden_boxes) == 0 or len(pred_boxes) == 0:
        return []
    iou = _iou_matrix(golden_boxes, pred_boxes)
    pairs = []
    used_g, used_p = set(), set()
    order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None), iou.shape))[0]
    for gi, pi in order:
        if iou[gi, pi] < iou_thr:
            break
        if gi in used_g or pi in used_p:
            continue
        used_g.add(int(gi))
        used_p.add(int(pi))
        pairs.append((int(gi), int(pi), float(iou[gi, pi])))
    return pairs


def compare_image(golden: dict, detections, iou_thr: float = 0.5,
                  golden_kpts=None, min_golden_conf: float = 0.0) -> dict:
    """One image: golden faces vs a list of (bbox_xyxy, score[, kpts 5x3]).

    Golden faces whose recorded confidence band tops out below
    ``min_golden_conf`` (e.g. the reference's conf-0.01 eval-run crops in the
    dense parade scenes) become IGNORE regions: they leave the recall
    denominator, and predictions landing on them don't hurt precision —
    the standard low-conf-oracle treatment (same idea as WIDERFACE ignore).

    With ``golden_kpts`` (per-face [5,3] arrays recovered from the
    reference's rendered detail images — tools/golden_keypoints.py), matched
    faces also score a landmark error: NME = mean landmark distance
    normalized by sqrt(golden box area), over recovered (v=1) landmarks."""
    scored_idx = [
        i for i, f in enumerate(golden["faces"])
        if f["conf_hi"] >= min_golden_conf
    ]
    ignore_idx = [
        i for i, f in enumerate(golden["faces"])
        if f["conf_hi"] < min_golden_conf
    ]
    faces = [golden["faces"][i] for i in scored_idx]
    g_boxes = np.array([f["bbox"] for f in faces], np.float32).reshape(-1, 4)
    ig_boxes = np.array(
        [golden["faces"][i]["bbox"] for i in ignore_idx], np.float32
    ).reshape(-1, 4)
    if golden_kpts is not None:
        # golden_keypoints.json can lag reference_goldens.json (fewer entries
        # than faces); absent entries score no landmark error instead of
        # aborting the parity run on an IndexError.
        golden_kpts = [
            golden_kpts[i] if i < len(golden_kpts) else None
            for i in scored_idx
        ]
    p_boxes = np.array([d[0] for d in detections], np.float32).reshape(-1, 4)
    p_scores = np.array([d[1] for d in detections], np.float32)
    pairs = match_detections(g_boxes, p_boxes, iou_thr)
    matched_p = {pi for _gi, pi, _ in pairs}
    n_ignored_p = 0
    if len(ig_boxes) and len(p_boxes):
        iou_ig = _iou_matrix(ig_boxes, p_boxes)
        for pi in range(len(p_boxes)):
            if pi not in matched_p and iou_ig[:, pi].max() >= iou_thr:
                n_ignored_p += 1
    conf_deltas, nmes, px_errs = [], [], []
    for gi, pi, _iou in pairs:
        lo = faces[gi]["conf_lo"]
        hi = faces[gi]["conf_hi"]
        s = float(p_scores[pi])
        conf_deltas.append(0.0 if lo <= s <= hi else min(abs(s - lo), abs(s - hi)))
        if (
            golden_kpts is not None
            and golden_kpts[gi] is not None
            and len(detections[pi]) > 2
            and detections[pi][2] is not None
        ):
            gk = np.asarray(golden_kpts[gi], np.float32)
            pk = np.asarray(detections[pi][2], np.float32).reshape(-1, 3)
            vis = gk[:, 2] > 0
            if vis.any() and pk.shape[0] == gk.shape[0]:
                d = np.linalg.norm(pk[vis, :2] - gk[vis, :2], axis=1)
                x1, y1, x2, y2 = g_boxes[gi]
                scale = max(np.sqrt(max((x2 - x1) * (y2 - y1), 1.0)), 1.0)
                nmes.append(float(d.mean() / scale))
                px_errs.append(float(d.mean()))
    n_g, n_m = len(g_boxes), len(pairs)
    n_p = len(p_boxes) - n_ignored_p
    out = {
        "golden_faces": n_g,
        "ignored_golden": len(ignore_idx),
        "predicted": n_p,
        "matched": n_m,
        "recall": n_m / n_g if n_g else 1.0,
        "precision": n_m / n_p if n_p else 1.0,
        "mean_iou": float(np.mean([p[2] for p in pairs])) if pairs else 0.0,
        "mean_conf_delta": float(np.mean(conf_deltas)) if conf_deltas else None,
    }
    if nmes:
        out["mean_kpt_nme"] = float(np.mean(nmes))
        out["mean_kpt_px_err"] = float(np.mean(px_errs))
        out["kpt_faces"] = len(nmes)
    return out


def run_parity(
    goldens: dict,
    ref_dir: str,
    detection_model,
    conf: float = 0.5,
    iou_thr: float = 0.5,
    operating_point: dict | None = None,
    keypoints: dict | None = None,
) -> dict:
    """Run the sliced pipeline on every golden image and aggregate agreement.

    ``keypoints``: the golden_keypoints.json dict (tools/golden_keypoints.py)
    — when given, matched faces also aggregate the landmark-error columns."""
    from facedet_tpu_torch.data.native_loader import load_image
    from facedet_tpu_torch.engine.predict import get_sliced_prediction

    op = dict(REFERENCE_OPERATING_POINT)
    op.update(operating_point or {})
    kp_images = (keypoints or {}).get("images", {})
    per_image = {}
    for name, golden in goldens["images"].items():
        src = os.path.join(ref_dir, name, "temp_sahi_input.jpg")
        if not os.path.exists(src):
            continue
        result = get_sliced_prediction(load_image(src), detection_model, **op)
        dets = [
            (p.bbox.to_xyxy(), p.score.value, p.keypoints)
            for p in result.object_prediction_list
            if p.score.value >= conf
        ]
        g_kpts = None
        if name in kp_images:
            g_kpts = [f["kpts"] for f in kp_images[name]["faces"]]
        per_image[name] = compare_image(
            golden, dets, iou_thr, golden_kpts=g_kpts, min_golden_conf=conf
        )
    matched = sum(r["matched"] for r in per_image.values())
    total_g = sum(r["golden_faces"] for r in per_image.values())
    total_p = sum(r["predicted"] for r in per_image.values())
    deltas = [
        r["mean_conf_delta"] for r in per_image.values() if r["mean_conf_delta"] is not None
    ]
    out = {
        "images": per_image,
        "recall": matched / total_g if total_g else None,
        "precision": matched / total_p if total_p else None,
        "mean_conf_delta": float(np.mean(deltas)) if deltas else None,
        "operating_point": {k: str(v) for k, v in op.items()},
    }
    kp_rows = [r for r in per_image.values() if "mean_kpt_nme" in r]
    if kp_rows:
        n = sum(r["kpt_faces"] for r in kp_rows)
        out["mean_kpt_nme"] = float(
            sum(r["mean_kpt_nme"] * r["kpt_faces"] for r in kp_rows) / n
        )
        out["mean_kpt_px_err"] = float(
            sum(r["mean_kpt_px_err"] * r["kpt_faces"] for r in kp_rows) / n
        )
        out["kpt_faces_scored"] = n
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--goldens", required=True)
    ap.add_argument("--ref-dir", required=True)
    ap.add_argument("--weights", help="converted checkpoint (.npz) for the detector; "
                    "facedet_tpu/eval/assets/yolo11n_golden.npz (trained by the JAX package's "
                    "tools/golden_finetune) "
                    "is the committed real-data checkpoint (use --scale n --imgsz 640)")
    ap.add_argument("--scale", default="s")
    ap.add_argument("--imgsz", type=int, default=1024)
    ap.add_argument("--conf", type=float, default=0.5)
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--out", help="write the full JSON report here")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    with open(args.goldens) as f:
        goldens = json.load(f)
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel

    model = YoloV11PoseDetectionModel(
        model_path=args.weights,
        scale=args.scale,
        dtype="bfloat16",
        # pin f32 BN so committed parity artifacts stay reproducible across
        # serving-dtype defaults (serving uses bf16 BN; boxes agree <1px)
        bn_dtype="float32",
        confidence_threshold=min(args.conf, 0.25),
        image_size=args.imgsz,
        device=args.device,
    )
    report = run_parity(goldens, args.ref_dir, model, conf=args.conf, iou_thr=args.iou)
    if not args.weights:
        report["note"] = (
            "random-init weights: agreement numbers are the harness smoke, "
            "not a parity claim — pass --weights with a converted checkpoint"
        )
    print(
        json.dumps(
            {k: v for k, v in report.items() if k != "images"}, indent=1
        )
    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
