"""Batch prediction over folders / COCO datasets.

Counterpart of facedet_tpu/engine/batch_predict.py (reference: docs
sahi/predict.py:385-786): ``predict()`` walks a source (folder / single
image / COCO json), runs standard or sliced prediction per image, and
exports visuals, crops, pickles and COCO predictions into an
auto-incremented ``runs/predict/exp*`` directory; plus the reading-order
aggregation helpers ``bbox_sort``/``agg_prediction`` (:348-382) and the
low-confidence auto-switch to NMS/IOU (:523-528). Video sources are not
ported yet.
"""
from __future__ import annotations

import json
import os
import pickle
import time
from functools import cmp_to_key
from pathlib import Path
from typing import Optional

LOW_MODEL_CONFIDENCE = 0.1
IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".y4m", ".m4v")

__all__ = [
    "predict",
    "predict_fiftyone",
    "bbox_sort",
    "agg_prediction",
    "increment_path",
]


def create_fiftyone_dataset_from_coco_file(image_dir: str, dataset_json_path: str):
    """Build a FiftyOne dataset from a COCO annotations file (the sahi
    ``create_fiftyone_dataset_from_coco_file`` util used at docs
    sahi/predict.py:880-890). Import-gated on the optional fiftyone package."""
    import fiftyone as fo

    return fo.Dataset.from_dir(
        dataset_type=fo.types.COCODetectionDataset,
        data_path=image_dir,
        labels_path=dataset_json_path,
        label_field="ground_truth",
    )


def predict_fiftyone(
    detection_model=None,
    dataset_json_path: str = "",
    image_dir: str = "",
    no_standard_prediction: bool = False,
    no_sliced_prediction: bool = False,
    image_size: Optional[int] = None,
    slice_height: int = 256,
    slice_width: int = 256,
    overlap_height_ratio: float = 0.2,
    overlap_width_ratio: float = 0.2,
    postprocess_type: str = "GREEDYNMM",
    postprocess_match_metric: str = "IOS",
    postprocess_match_threshold: float = 0.5,
    postprocess_class_agnostic: bool = False,
    model_confidence_threshold: Optional[float] = None,
    label_field: str = "predictions",
    launch_app: bool = True,
    verbose: int = 1,
):
    """FiftyOne-visualised batch prediction (docs sahi/predict.py:787-986):
    build a dataset from a COCO file, run standard/sliced prediction per
    sample, attach the detections, then launch the app and print a detection
    evaluation report. Import-gated on the optional fiftyone package; with
    ``launch_app=False`` the populated dataset is returned for offline use
    (and for tests via a stubbed ``fiftyone`` module)."""
    import fiftyone as fo

    from facedet_tpu_torch.data.native_loader import load_image
    from facedet_tpu_torch.engine.predict import get_prediction, get_sliced_prediction

    if no_standard_prediction and no_sliced_prediction:
        raise ValueError(
            "'no_standard_prediction' and 'no_sliced_prediction' cannot both be True"
        )
    if detection_model is None:
        raise ValueError("detection_model is required")
    if model_confidence_threshold is not None:
        detection_model.confidence_threshold = model_confidence_threshold
    if image_size is not None:
        detection_model.image_size = image_size

    dataset = create_fiftyone_dataset_from_coco_file(image_dir, dataset_json_path)

    durations = {"prediction": 0.0, "slice": 0.0}
    for sample in dataset:
        image = load_image(sample.filepath)
        if no_sliced_prediction:
            result = get_prediction(image, detection_model)
        else:
            result = get_sliced_prediction(
                image,
                detection_model,
                slice_height=slice_height,
                slice_width=slice_width,
                overlap_height_ratio=overlap_height_ratio,
                overlap_width_ratio=overlap_width_ratio,
                perform_standard_pred=not no_standard_prediction,
                postprocess_type=postprocess_type,
                postprocess_match_metric=postprocess_match_metric,
                postprocess_match_threshold=postprocess_match_threshold,
                postprocess_class_agnostic=postprocess_class_agnostic,
            )
        for k in ("prediction", "slice"):
            durations[k] += result.durations_in_seconds.get(k, 0.0)
        h, w = image.shape[:2]
        sample[label_field] = fo.Detections(
            detections=[
                p.to_fiftyone_detection(image_height=h, image_width=w)
                for p in result.object_prediction_list
            ]
        )
        sample.save()

    if verbose:
        print(f"Slicing performed in {durations['slice']:.2f} seconds.")
        print(f"Prediction performed in {durations['prediction']:.2f} seconds.")

    if launch_app:  # pragma: no cover - interactive
        app = fo.launch_app()
        app.dataset = dataset
        results = dataset.evaluate_detections(
            label_field,
            gt_field="ground_truth",
            eval_key="eval",
            iou=postprocess_match_threshold,
            compute_mAP=True,
        )
        counts = dataset.count_values("ground_truth.detections.label")
        top10 = sorted(counts, key=counts.get, reverse=True)[:10]
        results.print_report(classes=top10)
        app.view = dataset.load_evaluation_view("eval").sort_by(
            "eval_fp", reverse=True
        )
        while True:
            time.sleep(3)
    return dataset


def bbox_sort(a, b, thresh: float) -> float:
    """Reading-order comparator: same row (|dy| <= thresh) sorts by x, else by
    y (docs sahi/predict.py:348-365)."""
    if abs(a[1] - b[1]) <= thresh:
        return a[0] - b[0]
    return a[1] - b[1]


def agg_prediction(result, thresh: float) -> list[dict]:
    """Re-index COCO annotations in reading order (docs sahi/predict.py:367-382)."""
    res = result.to_coco_annotations()
    coords = [tuple(ann["bbox"]) for ann in res]
    ordered = sorted(coords, key=cmp_to_key(lambda a, b: bbox_sort(a, b, thresh)))
    for ann in res:
        ann["image_id"] = ordered.index(tuple(ann["bbox"]))
    return res


def increment_path(path: str, exist_ok: bool = False) -> str:
    """runs/predict/exp -> exp2, exp3, ... (ultralytics-style)."""
    p = Path(path)
    if exist_ok or not p.exists():
        return str(p)
    for n in range(2, 10_000):
        cand = f"{p}{n}"
        if not os.path.exists(cand):
            return cand
    raise RuntimeError("could not increment path")


def _list_images(source: str) -> list[str]:
    src = Path(source)
    if src.is_file():
        return [str(src)]
    return sorted(
        str(p)
        for p in src.rglob("*")
        if p.suffix.lower() in IMAGE_EXTENSIONS
    )


def predict(
    detection_model=None,
    source: Optional[str] = None,
    no_standard_prediction: bool = False,
    no_sliced_prediction: bool = False,
    image_size: Optional[int] = None,
    slice_height: int = 512,
    slice_width: int = 512,
    overlap_height_ratio: float = 0.2,
    overlap_width_ratio: float = 0.2,
    postprocess_type: str = "GREEDYNMM",
    postprocess_match_metric: str = "IOS",
    postprocess_match_threshold: float = 0.5,
    postprocess_class_agnostic: bool = False,
    novisual: bool = False,
    export_pickle: bool = False,
    export_crop: bool = False,
    dataset_json_path: Optional[str] = None,
    project: str = "runs/predict",
    name: str = "exp",
    model_confidence_threshold: Optional[float] = None,
    force_postprocess_type: bool = False,
    exclude_classes_by_name: Optional[list[str]] = None,
    exclude_classes_by_id: Optional[list[int]] = None,
    verbose: int = 1,
    return_dict: bool = True,
    ingest: str = "rgb",
) -> Optional[dict]:
    """Folder/image/COCO batch prediction (docs sahi/predict.py:385).
    ``ingest`` picks the upload format of the sliced path: ``"yuv420"``
    decodes JPEGs to planes, ``"dct420"`` / ``"dct420s"`` read their stored
    coefficients (data/native_loader.py). A video source raises: the video
    branch is not ported yet."""
    if source and str(source).lower().endswith(VIDEO_EXTENSIONS):
        raise NotImplementedError("video sources are not yet ported to facedet_tpu_torch")
    from facedet_tpu_torch.data.native_loader import load_image
    from facedet_tpu_torch.engine.predict import get_prediction, get_sliced_prediction
    from facedet_tpu_torch.utils.viz import (
        draw_detections_on_image,
        save_face_crops,
        save_image,
    )

    if no_standard_prediction and no_sliced_prediction:
        raise ValueError(
            "'no_standard_prediction' and 'no_sliced_prediction' cannot both be True"
        )
    if detection_model is None:
        raise ValueError("detection_model is required")
    if model_confidence_threshold is not None:
        detection_model.confidence_threshold = model_confidence_threshold
    conf = detection_model.confidence_threshold
    if not force_postprocess_type and conf < LOW_MODEL_CONFIDENCE and postprocess_type != "NMS":
        # auto-switch (docs sahi/predict.py:523-528)
        postprocess_type = "NMS"
        postprocess_match_metric = "IOU"
    if image_size is not None:
        detection_model.image_size = image_size

    save_dir = Path(increment_path(Path(project) / name))
    crop_dir = save_dir / "crops"
    visual_dir = save_dir / "visuals"
    pickle_dir = save_dir / "pickles"
    exporting = (not novisual) or export_pickle or export_crop or dataset_json_path
    if exporting:
        save_dir.mkdir(parents=True, exist_ok=True)

    # source list: folder walk or COCO file_names
    coco_images = None
    if dataset_json_path:
        with open(dataset_json_path) as f:
            coco_images = json.load(f)["images"]
        image_paths = [os.path.join(source or "", im["file_name"]) for im in coco_images]
    else:
        image_paths = _list_images(source)

    durations = {"prediction": 0.0, "slice": 0.0, "export_files": 0.0}
    coco_json = []
    num_images = len(image_paths)
    if ingest != "rgb" and no_sliced_prediction:
        raise ValueError(
            "ingest formats other than 'rgb' require the sliced path "
            "(no_sliced_prediction=False)"
        )
    for idx, img_path in enumerate(image_paths):
        if ingest in ("dct420", "dct420s"):
            from facedet_tpu_torch.data.native_loader import load_image_dct420

            image = load_image_dct420(img_path)
        elif ingest == "yuv420":
            from facedet_tpu_torch.data.native_loader import load_image_yuv420

            image = load_image_yuv420(img_path)
        else:
            image = load_image(img_path)
        if no_sliced_prediction:
            result = get_prediction(image, detection_model)
        else:
            result = get_sliced_prediction(
                image,
                detection_model,
                slice_height=slice_height,
                slice_width=slice_width,
                overlap_height_ratio=overlap_height_ratio,
                overlap_width_ratio=overlap_width_ratio,
                perform_standard_pred=not no_standard_prediction,
                postprocess_type=postprocess_type,
                postprocess_match_metric=postprocess_match_metric,
                postprocess_match_threshold=postprocess_match_threshold,
                postprocess_class_agnostic=postprocess_class_agnostic,
                input_format=ingest,
            )
        if ingest != "rgb":
            image = result.image  # reconstructed RGB for crops/visuals
        if exclude_classes_by_name or exclude_classes_by_id:
            # class-exclusion filter (docs sahi/predict.py filter_predictions)
            result.object_prediction_list = [
                p
                for p in result.object_prediction_list
                if not (
                    (exclude_classes_by_name and p.category.name in exclude_classes_by_name)
                    or (exclude_classes_by_id and p.category.id in exclude_classes_by_id)
                )
            ]
        for k in ("prediction", "slice"):
            durations[k] += result.durations_in_seconds.get(k, 0.0)

        stem = Path(img_path).stem
        t0 = time.time()
        if dataset_json_path and coco_images is not None:
            image_id = coco_images[idx]["id"]
            coco_json.extend(result.to_coco_predictions(image_id=image_id))
        if export_crop:
            save_face_crops(
                image, result.object_prediction_list, str(crop_dir / stem), prefix=stem
            )
        if export_pickle:
            pickle_dir.mkdir(parents=True, exist_ok=True)
            with open(pickle_dir / f"{stem}.pickle", "wb") as f:
                pickle.dump(result.object_prediction_list, f)
        if not novisual:
            visual_dir.mkdir(parents=True, exist_ok=True)
            vis = draw_detections_on_image(image, result.object_prediction_list)
            save_image(str(visual_dir / f"{stem}.png"), vis)
        durations["export_files"] += time.time() - t0
        if verbose:
            print(
                f"[{idx + 1}/{num_images}] {stem}: "
                f"{len(result.object_prediction_list)} detections"
            )

    if dataset_json_path and exporting:
        with open(save_dir / "result.json", "w") as f:
            json.dump(coco_json, f)
    if verbose and exporting:
        print(f"Prediction results are successfully exported to {save_dir}")
    if return_dict:
        return {
            "export_dir": str(save_dir),
            "durations_in_seconds": durations,
            "num_images": num_images,
        }
    return None
