"""Official WIDERFACE evaluation protocol (Easy/Medium/Hard AP).

Reference: eval/eval_official_widerface.py:44-541 — which itself embeds the
official WIDER Face evaluation script (``_image_eval`` :302, ``_img_pr_info``
:351, ``_dataset_pr_info`` :379, ``_voc_ap`` :282). This module re-implements
the protocol as pure host-numpy functions (vectorised over the 1000-threshold
PR accumulation) driving the native ``bbox_overlaps`` matrix, plus the
evaluator class with the reference's four pipeline modes: standard /
sahi-uniform / sahi-adaptive, each ± (bounded) enhancement
(:500-538,166-252).

Counterpart of facedet_tpu/eval/widerface_official.py: the protocol functions
are a float64 numpy copy; the evaluator drives the port's engine, with the
enhanced image kept on the device for the sliced path.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np

from facedet_tpu_torch.eval.bbox_overlaps import bbox_overlaps

THRESH_NUM = 1000

__all__ = [
    "voc_ap",
    "image_eval",
    "img_pr_info",
    "dataset_pr_info",
    "evaluate_setting",
    "OfficialWiderFaceEvaluator",
]


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """Precision-envelope AP (eval/eval_official_widerface.py:282-300)."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def image_eval(
    pred: np.ndarray, gt: np.ndarray, ignore: np.ndarray, iou_threshold: float = 0.5
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy per-image GT matching with ignore handling
    (eval/eval_official_widerface.py:302-349).

    pred: [P,5] xywh+score (sorted by descending score), gt: [G,4] xywh,
    ignore: [G] (1 = evaluate, 0 = ignore). Returns (pred_recall [P],
    proposal_list [P] with 1=TP-eligible, -1=ignored)."""
    _pred = pred.astype(np.float64, copy=True)
    _gt = gt.astype(np.float64, copy=True)
    pred_recall = np.zeros(_pred.shape[0])
    recall_list = np.zeros(_gt.shape[0])
    proposal_list = np.ones(_pred.shape[0])

    _pred[:, 2] += _pred[:, 0]
    _pred[:, 3] += _pred[:, 1]
    _gt[:, 2] += _gt[:, 0]
    _gt[:, 3] += _gt[:, 1]

    overlaps = bbox_overlaps(_pred[:, :4], _gt)
    matched = 0
    for h in range(_pred.shape[0]):
        gt_overlap = overlaps[h]
        max_idx = int(gt_overlap.argmax())
        if gt_overlap[max_idx] >= iou_threshold:
            if ignore[max_idx] == 0:
                recall_list[max_idx] = -1
                proposal_list[h] = -1
            elif recall_list[max_idx] == 0:
                recall_list[max_idx] = 1
                matched += 1
        pred_recall[h] = matched
    return pred_recall, proposal_list


def img_pr_info(
    pred_info: np.ndarray,
    proposal_list: np.ndarray,
    pred_recall: np.ndarray,
    thresh_num: int = THRESH_NUM,
) -> np.ndarray:
    """Per-image PR accumulation over ``thresh_num`` score thresholds
    (eval/eval_official_widerface.py:351-377), vectorised: with predictions
    sorted by descending score, the official per-threshold ``r_index[-1]`` is a
    searchsorted over the score column and the TP count is a prefix sum."""
    scores = pred_info[:, 4]
    threshs = 1.0 - (np.arange(thresh_num) + 1.0) / thresh_num
    # number of predictions with score >= thresh (descending-sorted scores)
    counts = np.searchsorted(-scores, -threshs, side="right")
    cum_tp = np.cumsum(proposal_list == 1)
    pr = np.zeros((thresh_num, 2))
    nz = counts > 0
    r_idx = counts[nz] - 1
    pr[nz, 0] = cum_tp[r_idx]
    pr[nz, 1] = pred_recall[r_idx]
    return pr


def dataset_pr_info(pr_curve: np.ndarray, count_face: int) -> np.ndarray:
    """(eval/eval_official_widerface.py:379-396)."""
    out = np.zeros_like(pr_curve)
    nz = pr_curve[:, 0] != 0
    out[nz, 0] = pr_curve[nz, 1] / pr_curve[nz, 0]
    out[:, 1] = pr_curve[:, 1] / max(count_face, 1)
    return out


def evaluate_setting(
    predictions: dict[str, dict[str, np.ndarray]],
    facebox_list: dict[str, dict[str, np.ndarray]],
    keep_list: Optional[dict[str, dict[str, np.ndarray]]] = None,
    iou_threshold: float = 0.5,
    thresh_num: int = THRESH_NUM,
) -> tuple[float, np.ndarray, np.ndarray]:
    """Evaluate one difficulty setting (eval/eval_official_widerface.py:398-453).

    predictions / facebox_list: {event: {image: array}} with predictions
    [P,5] xywh+score and GT [G,4] xywh. keep_list gives 1-based indices of GT
    to evaluate for the setting (None = evaluate all). Returns (AP, recall,
    precision) arrays over the threshold sweep."""
    count_face = 0
    pr_curve = np.zeros((thresh_num, 2))
    for event, images in facebox_list.items():
        pred_event = predictions.get(event, {})
        for img_name, gt_boxes in images.items():
            gt_boxes = np.asarray(gt_boxes, float).reshape(-1, 4)
            if keep_list is None:
                keep_index = np.arange(1, gt_boxes.shape[0] + 1)
            else:
                keep_index = np.asarray(
                    keep_list.get(event, {}).get(img_name, []), int
                ).reshape(-1)
            count_face += len(keep_index)
            pred_info = np.asarray(pred_event.get(img_name, np.zeros((0, 5))), float)
            if gt_boxes.shape[0] == 0 or pred_info.shape[0] == 0:
                continue
            order = np.argsort(-pred_info[:, 4], kind="stable")
            pred_info = pred_info[order]
            ignore = np.zeros(gt_boxes.shape[0])
            if len(keep_index) != 0:
                ignore[keep_index - 1] = 1
            pred_recall, proposal_list = image_eval(
                pred_info, gt_boxes, ignore, iou_threshold
            )
            pr_curve += img_pr_info(pred_info, proposal_list, pred_recall, thresh_num)
    pr_curve = dataset_pr_info(pr_curve, count_face)
    precision, recall = pr_curve[:, 0], pr_curve[:, 1]
    return voc_ap(recall, precision), recall, precision


class OfficialWiderFaceEvaluator:
    """Four-mode WIDERFACE evaluator (eval/eval_official_widerface.py:44-541):
    standard | SAHI-uniform | SAHI-adaptive, each optionally preceded by
    (bounded) Real-ESRGAN enhancement with divide-by-scale coordinate mapping
    (:245-252)."""

    def __init__(
        self,
        detection_model,
        images_path: str,
        gt_path: Optional[str] = None,
        gt_txt: Optional[str] = None,
        use_sahi: bool = True,
        slicing_strategy: str = "uniform",  # uniform | adaptive
        sahi_config: Optional[dict] = None,
        enhancer=None,
        perform_standard_pred: bool = True,
        bounded_enhancement: bool = False,
        face_size_threshold: float = 50.0,
        iou_threshold: float = 0.5,
        thresh_num: int = THRESH_NUM,
        inference_confidence: float = 0.01,
        output_dir: str = "output",
        image_loader: Optional[Callable[[str], np.ndarray]] = None,
        ingest: str = "rgb",
    ):
        self.detection_model = detection_model
        self.images_path = images_path
        self.use_sahi = use_sahi
        self.slicing_strategy = slicing_strategy
        self.sahi_config = sahi_config or {
            "slice_height": 640,
            "slice_width": 640,
            "overlap_ratio": 0.2,
        }
        self.enhancer = enhancer
        self.perform_standard_pred = perform_standard_pred
        self.bounded_enhancement = bounded_enhancement
        self.face_size_threshold = face_size_threshold
        self.iou_threshold = iou_threshold
        self.thresh_num = thresh_num
        self.inference_confidence = inference_confidence
        self.output_dir = output_dir
        self.image_loader = image_loader
        if ingest not in ("rgb", "yuv420", "dct420", "dct420s"):
            raise ValueError(f"unknown ingest {ingest!r}")
        if ingest != "rgb" and (enhancer is not None or not use_sahi):
            # the enhancer and the standard (letterbox) path consume pixels
            raise ValueError(
                "ingest formats other than 'rgb' require use_sahi=True "
                "and no enhancer"
            )
        self.ingest = ingest
        self.mode_string = self._build_mode_string()
        self.timings: dict[str, float] = {"inference_s": 0.0, "images": 0}

        self.gt = None
        if gt_path is not None:
            from facedet_tpu_torch.data.widerface import load_official_mat_gt

            self.gt = self._mat_to_dicts(load_official_mat_gt(gt_path))
        elif gt_txt is not None:
            from facedet_tpu_torch.data.widerface import (
                gt_txt_to_keep_lists,
                gt_txt_to_prediction_structures,
                parse_wider_gt_txt,
            )

            ann = parse_wider_gt_txt(gt_txt)
            boxes = gt_txt_to_prediction_structures(ann)
            # honour the txt's invalid flag through the keep list; when no
            # face is marked invalid this is identical to keep=None (all GT)
            keep = gt_txt_to_keep_lists(ann)
            self.gt = {"facebox_list": boxes, "setting_gts": {"all": keep}}

    def _build_mode_string(self) -> str:
        parts = []
        if self.enhancer is not None:
            parts.append(
                f"BOUNDED-ENHANCE (<{self.face_size_threshold}px)"
                if self.bounded_enhancement
                else "FULL-ENHANCE"
            )
        parts.append(f"SAHI ({self.slicing_strategy})" if self.use_sahi else "BASELINE")
        return " -> ".join(parts)

    @staticmethod
    def _mat_to_dicts(mat: dict) -> dict:
        """Flatten the .mat cell arrays into {event: {image: array}} dicts."""
        facebox, keeps = {}, {s: {} for s in mat["setting_gts"]}
        for i in range(len(mat["event_list"])):
            event = mat["event_list"][i][0][0]
            img_list = mat["file_list"][i][0]
            gt_bbx_list = mat["facebox_list"][i][0]
            facebox[event] = {}
            for s in keeps:
                keeps[s][event] = {}
            for j in range(len(img_list)):
                name = img_list[j][0][0]
                facebox[event][name] = gt_bbx_list[j][0].astype(float)
                for s, gl in mat["setting_gts"].items():
                    k = gl[i][0][j][0]
                    keeps[s][event][name] = np.asarray(k, int).reshape(-1)
        return {"facebox_list": facebox, "setting_gts": keeps}

    # --- inference ------------------------------------------------------
    def _load_image(self, path: str) -> Optional[np.ndarray]:
        if self.image_loader is not None:
            return self.image_loader(path)
        from facedet_tpu_torch.data.native_loader import load_image

        return load_image(path) if os.path.exists(path) else None

    def run_single_inference(self, img: np.ndarray) -> np.ndarray:
        """One image -> [P,5] xywh+score (eval/eval_official_widerface.py:166-252)."""
        from facedet_tpu_torch.engine.enhancer import image_to_device
        from facedet_tpu_torch.engine.pipelines import quick_face_analysis
        from facedet_tpu_torch.engine.predict import _image_hw, get_prediction, get_sliced_prediction
        from facedet_tpu_torch.ops.tiler import adaptive_slice_size

        inference_img = img
        was_enhanced = False
        if self.enhancer is not None:
            enhance = True
            if self.bounded_enhancement:
                enhance = quick_face_analysis(
                    img, self.detection_model, self.face_size_threshold
                )
            if enhance:
                # keep the SR output on the device: the sliced path slices
                # it there (engine/predict.py), skipping the fetch and
                # re-upload of a tensor outscale^2 times the original
                inference_img = self.enhancer.enhance_array(
                    image_to_device(img, self.enhancer.device)
                )
                was_enhanced = True

        old_conf = self.detection_model.confidence_threshold
        self.detection_model.confidence_threshold = self.inference_confidence
        try:
            if self.use_sahi:
                h, w = _image_hw(inference_img)
                if self.slicing_strategy == "uniform":
                    sh = self.sahi_config["slice_height"]
                    sw = self.sahi_config["slice_width"]
                else:
                    sh = sw = adaptive_slice_size(h, w)
                result = get_sliced_prediction(
                    inference_img,
                    self.detection_model,
                    slice_height=sh,
                    slice_width=sw,
                    overlap_height_ratio=self.sahi_config["overlap_ratio"],
                    overlap_width_ratio=self.sahi_config["overlap_ratio"],
                    perform_standard_pred=self.perform_standard_pred,
                    postprocess_type="NMS",
                    postprocess_match_metric="IOU",
                    postprocess_match_threshold=0.5,
                    postprocess_class_agnostic=True,
                    merge_capacity=2048,
                    input_format=self.ingest,
                    return_image=False,  # eval wants boxes, not a display fetch
                )
            else:
                if was_enhanced:  # the standard path letterboxes on the host
                    inference_img = np.clip(
                        np.rint(inference_img.cpu().numpy() * 255.0), 0, 255
                    ).astype(np.uint8)
                result = get_prediction(inference_img, self.detection_model)
        finally:
            self.detection_model.confidence_threshold = old_conf

        preds = result.object_prediction_list
        if not preds:
            return np.zeros((0, 5))
        boxes = np.array([[*p.bbox.to_xywh(), p.score.value] for p in preds], float)
        if was_enhanced and self.enhancer.outscale > 1:
            boxes[:, :4] /= self.enhancer.outscale
        return boxes

    def run_inference_on_all_images(self) -> dict[str, dict[str, np.ndarray]]:
        """Eval inference loop (eval/eval_official_widerface.py:254-278) with
        native-decoder IO prefetch overlapping the device work."""
        predictions: dict[str, dict[str, np.ndarray]] = {}
        items = [
            (event, name, os.path.join(self.images_path, event, f"{name}.jpg"))
            for event, images in self.gt["facebox_list"].items()
            for name in images
        ]
        for event, _, _ in items:
            predictions.setdefault(event, {})

        if self.image_loader is not None:
            loaded = ((path, self._load_image(path)) for _, _, path in items)
        else:
            from facedet_tpu_torch.data.native_loader import (
                load_image_dct420,
                load_image_yuv420,
                prefetch_images,
            )

            loader = {
                "dct420": load_image_dct420,
                "dct420s": load_image_dct420,
                "yuv420": load_image_yuv420,
            }.get(self.ingest)
            loaded = prefetch_images(
                [path for _, _, path in items], num_workers=4, loader=loader
            )
        for (event, name, _path), (_p, img) in zip(items, loaded):
            if img is None:
                continue
            t0 = time.perf_counter()
            predictions[event][name] = self.run_single_inference(img)
            self.timings["inference_s"] += time.perf_counter() - t0
            self.timings["images"] += 1
        return predictions

    # --- protocol -------------------------------------------------------
    def run(self, predictions: Optional[dict] = None, save: bool = True) -> dict:
        """Full inference + three-setting evaluation
        (eval/eval_official_widerface.py:455-496)."""
        if self.gt is None:
            raise RuntimeError("no ground truth configured (gt_path or gt_txt)")
        if predictions is None:
            predictions = self.run_inference_on_all_images()
        results = {"mode": self.mode_string, "aps": {}, "curves": {}}
        for setting, keep in self.gt["setting_gts"].items():
            ap, recall, precision = evaluate_setting(
                predictions,
                self.gt["facebox_list"],
                keep,
                self.iou_threshold,
                self.thresh_num,
            )
            results["aps"][setting] = ap
            results["curves"][setting] = {
                "recall": recall.tolist(),
                "precision": precision.tolist(),
            }
        if self.timings["images"]:
            results["images_per_second"] = self.timings["images"] / max(
                self.timings["inference_s"], 1e-9
            )
        if save:
            os.makedirs(self.output_dir, exist_ok=True)
            with open(os.path.join(self.output_dir, "official_eval_results.json"), "w") as f:
                json.dump({k: v for k, v in results.items() if k != "curves"}, f, indent=2)
            self._plot_pr_curves(results)
        return results

    def _plot_pr_curves(self, results: dict) -> Optional[str]:
        """PR-curve PNG (eval/eval_official_widerface.py:478-496); gated on
        matplotlib availability."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        fig, ax = plt.subplots(figsize=(8, 6))
        for setting, curve in results["curves"].items():
            ax.plot(
                curve["recall"],
                curve["precision"],
                label=f"{setting} (AP={results['aps'][setting]:.4f})",
            )
        ax.set_xlabel("Recall")
        ax.set_ylabel("Precision")
        ax.set_title(f"WIDERFACE PR — {self.mode_string}")
        ax.legend()
        ax.grid(alpha=0.3)
        path = os.path.join(
            self.output_dir, f"pr_curve_{self.mode_string.replace(' ', '_')}.png"
        )
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
