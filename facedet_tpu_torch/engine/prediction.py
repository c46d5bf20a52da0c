"""API-edge prediction objects (counterpart of facedet_tpu/engine/prediction.py).

Compatibility layer mirroring the reference's data model
(docs sahi/prediction.py: PredictionScore :13, ObjectPrediction :44,
PredictionResult :166) so downstream code written against the reference's
attribute surface (``.bbox.to_xyxy()``, ``.score.value``, ``.category.name``,
``.object_prediction_list``) ports unchanged. On-device compute never touches
these objects — they are materialised from ``Detections`` tensors at the edge.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import numpy as np

from facedet_tpu_torch.core.detections import Detections


class PredictionScore:
    def __init__(self, value: float):
        self.value = float(value)

    def is_greater_than_threshold(self, threshold: float) -> bool:
        return self.value > threshold

    def __repr__(self):
        return f"PredictionScore(value={self.value:.4f})"


class Category:
    def __init__(self, id: int = 0, name: str = "face"):
        self.id = int(id)
        self.name = name

    def __repr__(self):
        return f"Category(id={self.id}, name={self.name!r})"


class BoundingBox:
    """xyxy box with the reference's accessor surface."""

    def __init__(self, box: Sequence[float], shift_amount: Sequence[float] = (0, 0)):
        self.minx, self.miny, self.maxx, self.maxy = (float(v) for v in box)
        self.shift_x, self.shift_y = float(shift_amount[0]), float(shift_amount[1])

    def to_xyxy(self) -> list[float]:
        return [self.minx, self.miny, self.maxx, self.maxy]

    def to_xywh(self) -> list[float]:
        return [self.minx, self.miny, self.maxx - self.minx, self.maxy - self.miny]

    @property
    def area(self) -> float:
        return max(0.0, self.maxx - self.minx) * max(0.0, self.maxy - self.miny)

    def get_shifted_box(self) -> "BoundingBox":
        return BoundingBox(
            [
                self.minx + self.shift_x,
                self.miny + self.shift_y,
                self.maxx + self.shift_x,
                self.maxy + self.shift_y,
            ]
        )

    def __repr__(self):
        return f"BoundingBox(xyxy=[{self.minx:.1f}, {self.miny:.1f}, {self.maxx:.1f}, {self.maxy:.1f}])"


class ObjectPrediction:
    """One detection at the API edge (reference docs sahi/prediction.py:44),
    with keypoints as a first-class field instead of the reference's
    string-keyed side cache (utils/yolo_wrapper.py:156-162)."""

    def __init__(
        self,
        bbox: Sequence[float],
        score: float,
        category_id: int = 0,
        category_name: str = "face",
        shift_amount: Sequence[float] = (0, 0),
        full_shape: Optional[Sequence[int]] = None,
        keypoints: Optional[np.ndarray] = None,
    ):
        self.bbox = BoundingBox(bbox, shift_amount)
        self.score = PredictionScore(score)
        self.category = Category(category_id, category_name)
        self.full_shape = list(full_shape) if full_shape is not None else None
        self.keypoints = (
            np.asarray(keypoints, np.float32) if keypoints is not None else None
        )

    def get_shifted_object_prediction(self) -> "ObjectPrediction":
        """Slice-local -> global coordinates (docs sahi/prediction.py:94)."""
        kpts = None
        if self.keypoints is not None:
            kpts = self.keypoints.copy()
            kpts[..., 0] += self.bbox.shift_x
            kpts[..., 1] += self.bbox.shift_y
        return ObjectPrediction(
            bbox=self.bbox.get_shifted_box().to_xyxy(),
            score=self.score.value,
            category_id=self.category.id,
            category_name=self.category.name,
            full_shape=self.full_shape,
            keypoints=kpts,
        )

    def to_fiftyone_detection(self, image_height: int, image_width: int):
        """FiftyOne export (docs sahi/prediction.py:144); gated on the
        optional fiftyone package."""
        try:
            import fiftyone as fo
        except ImportError as e:  # pragma: no cover
            raise ImportError("fiftyone is not installed on this host") from e
        x1, y1, x2, y2 = self.bbox.to_xyxy()
        rel_box = [
            x1 / image_width,
            y1 / image_height,
            (x2 - x1) / image_width,
            (y2 - y1) / image_height,
        ]
        return fo.Detection(
            label=self.category.name, bounding_box=rel_box, confidence=self.score.value
        )

    def to_coco_prediction(self, image_id: Any = None) -> dict:
        """COCO-format dict (docs sahi/prediction.py:122)."""
        return {
            "image_id": image_id,
            "category_id": self.category.id,
            "bbox": [round(v, 2) for v in self.bbox.to_xywh()],
            "score": round(self.score.value, 5),
            "category_name": self.category.name,
        }

    def __repr__(self):
        return (
            f"ObjectPrediction({self.bbox}, score={self.score.value:.3f}, "
            f"category={self.category.name})"
        )


def detections_to_object_predictions(
    det: Detections,
    category_mapping: Optional[dict] = None,
    full_shape: Optional[Sequence[int]] = None,
    with_keypoints: bool = True,
) -> list[ObjectPrediction]:
    """Materialise API-edge objects from a (single-image) Detections tensor."""
    arr = det.to_numpy()
    category_mapping = category_mapping or {"0": "face"}
    preds = []
    for i in range(arr["boxes"].shape[0]):
        cid = int(arr["classes"][i])
        preds.append(
            ObjectPrediction(
                bbox=arr["boxes"][i],
                score=float(arr["scores"][i]),
                category_id=cid,
                category_name=category_mapping.get(str(cid), str(cid)),
                full_shape=full_shape,
                keypoints=arr["kpts"][i] if with_keypoints else None,
            )
        )
    return preds


@dataclasses.dataclass
class PredictionResult:
    """Reference docs sahi/prediction.py:166 — image + predictions + timings."""

    image: np.ndarray
    object_prediction_list: list[ObjectPrediction]
    durations_in_seconds: dict[str, float] = dataclasses.field(default_factory=dict)
    detections: Optional[Detections] = None  # the on-device tensor form

    def to_coco_predictions(self, image_id: Any = None) -> list[dict]:
        return [p.to_coco_prediction(image_id) for p in self.object_prediction_list]

    def to_coco_annotations(self) -> list[dict]:
        anns = []
        for i, p in enumerate(self.object_prediction_list):
            ann = p.to_coco_prediction()
            ann.update({"id": i, "area": p.bbox.area, "iscrowd": 0})
            anns.append(ann)
        return anns

    def export_visuals(
        self, export_dir: str, file_name: str = "prediction_visual", **kwargs
    ) -> str:
        """Draw detections and save a PNG (docs sahi/prediction.py:178)."""
        from facedet_tpu_torch.utils.viz import draw_detections_on_image, save_image

        os.makedirs(export_dir, exist_ok=True)
        vis = draw_detections_on_image(self.image, self.object_prediction_list, **kwargs)
        path = os.path.join(export_dir, f"{file_name}.png")
        save_image(path, vis)
        return path
