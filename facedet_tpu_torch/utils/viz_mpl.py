"""Matplotlib visualizer — the reference's second (legacy) viz path.

Reference: docs sahi/visualization.py:11-143 — ``FaceVisualizer`` drawing
detections via matplotlib patches into an RGB array (:17-68), crop saving
(:71) and a text summary (:106), duplicating utils/visualization.py. Kept as a
distinct class for parity.

Counterpart of facedet_tpu/utils/viz_mpl.py, copied. matplotlib is imported
only inside ``draw_detections``: the other methods need PIL alone, and a
machine without matplotlib (the card's may lack it) can import the module.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["FaceVisualizer"]


class FaceVisualizer:
    def __init__(self, box_color: str = "red", text_color: str = "white"):
        self.box_color = box_color
        self.text_color = text_color

    def draw_detections(
        self, image: np.ndarray, predictions: Sequence, title: Optional[str] = None
    ) -> np.ndarray:
        """Array -> annotated RGB array via matplotlib patches
        (docs sahi/visualization.py:17-68)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.patches as patches
        import matplotlib.pyplot as plt

        h, w = image.shape[:2]
        dpi = 100
        fig, ax = plt.subplots(figsize=(w / dpi, h / dpi), dpi=dpi)
        ax.imshow(image)
        ax.axis("off")
        for p in predictions:
            x1, y1, x2, y2 = p.bbox.to_xyxy()
            ax.add_patch(
                patches.Rectangle(
                    (x1, y1), x2 - x1, y2 - y1, fill=False, edgecolor=self.box_color, lw=2
                )
            )
            ax.text(
                x1,
                max(0, y1 - 4),
                f"{p.category.name} {p.score.value:.2f}",
                color=self.text_color,
                fontsize=8,
                bbox=dict(facecolor=self.box_color, alpha=0.6, pad=1),
            )
        if title:
            ax.set_title(title)
        fig.subplots_adjust(left=0, right=1, top=1, bottom=0)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        plt.close(fig)
        return buf

    def save_face_crops(
        self,
        image: np.ndarray,
        detections,
        output_dir: str,
        prefix: str = "face_crop",
    ) -> list[str]:
        """Crop each detection out of ``image`` and save it as
        ``{prefix}_{i+1}_conf_{score:.2f}.jpg`` (1-indexed, unlike the primary
        viz path's 0-indexed names — docs sahi/visualization.py:71-103).

        Accepts a ``PredictionResult``, a prediction list, or raw
        ``[x1,y1,x2,y2,(score)]`` rows; zero-area crops are skipped.
        """
        from PIL import Image

        os.makedirs(output_dir, exist_ok=True)
        preds = getattr(detections, "object_prediction_list", detections)
        h, w = image.shape[:2]
        saved: list[str] = []
        for i, det in enumerate(preds):
            if hasattr(det, "bbox"):
                bbox = det.bbox.to_xyxy() if hasattr(det.bbox, "to_xyxy") else det.bbox
                score = getattr(det, "score", None)
                conf = float(getattr(score, "value", score or 0.0))
            else:
                bbox = det[:4]
                conf = float(det[4]) if len(det) > 4 else 1.0
            x1, y1, x2, y2 = (int(c) for c in bbox)
            x1, x2 = max(0, x1), min(w, x2)
            y1, y2 = max(0, y1), min(h, y2)
            if x2 <= x1 or y2 <= y1:
                continue
            path = os.path.join(output_dir, f"{prefix}_{i + 1}_conf_{conf:.2f}.jpg")
            Image.fromarray(np.ascontiguousarray(image[y1:y2, x1:x2])).save(path, quality=95)
            saved.append(path)
        return saved

    def create_detection_summary(
        self, results: dict, save_path: Optional[str] = None
    ) -> str:
        """Format a detection-statistics dict (``image_path``, ``num_faces``,
        ``processing_time``, ``avg/min/max_confidence``, ``detections`` rows of
        ``{bbox, confidence}``) into a text report, optionally saved
        (docs sahi/visualization.py:106-143). Distinct from
        utils/viz.create_detection_summary, which reports per-prediction
        keypoints instead of aggregate stats.
        """
        lines = [
            "=== Face Detection Summary ===",
            f"Image: {results.get('image_path', 'Unknown')}",
            f"Total Faces Detected: {results.get('num_faces', 0)}",
            f"Processing Time: {results.get('processing_time', 0):.2f} seconds",
            f"Average Confidence: {results.get('avg_confidence', 0):.2f}",
            f"Min Confidence: {results.get('min_confidence', 0):.2f}",
            f"Max Confidence: {results.get('max_confidence', 0):.2f}",
            "",
            "Detection Details:",
        ]
        for i, det in enumerate(results.get("detections", [])):
            b = det.get("bbox", [0, 0, 0, 0])
            lines.append(
                f"Face {i + 1}: BBox({b[0]:.0f}, {b[1]:.0f}, {b[2]:.0f}, {b[3]:.0f}), "
                f"Conf: {det.get('confidence', 0):.3f}"
            )
        summary = "\n".join(lines) + "\n"
        if save_path:
            with open(save_path, "w") as f:
                f.write(summary)
        return summary
