"""Shared CLI plumbing for the port's apps (counterpart of
facedet_tpu/apps/common.py). Only the yolov11 family and rgb ingest are
ported; the other choices exit with "not yet ported"."""
from __future__ import annotations

import argparse
import os

from facedet_tpu_torch.utils.config import DetectorConfig


def build_detector(cfg: DetectorConfig, device: str = "cuda"):
    if cfg.family == "yolov11":
        from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel

        return YoloV11PoseDetectionModel(
            model_path=cfg.model_path,
            scale=cfg.scale,
            dtype=cfg.dtype,
            confidence_threshold=cfg.confidence_threshold,
            image_size=cfg.image_size,
            max_detections_per_tile=cfg.max_detections_per_tile,
            device=device,
        )
    raise SystemExit(f"error: detector family {cfg.family!r} is not yet ported to facedet_tpu_torch")


def base_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--input", default="data/input", help="image file or folder")
    ap.add_argument("--output", default="data/output")
    ap.add_argument("--model-path", default=None, help=".npz checkpoint of the JAX package")
    ap.add_argument(
        "--family", default="yolov11",
        choices=["yolov11", "scrfd", "rtdetr", "onnx", "fake"],
        help="only yolov11 is ported",
    )
    ap.add_argument("--scale", default="s", help="yolo model scale n/s/m/l/x")
    ap.add_argument("--conf", type=float, default=0.3)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--slice", type=int, default=640)
    ap.add_argument("--overlap", type=float, default=0.2)
    ap.add_argument("--config", default=None, help="PipelineConfig json path")
    ap.add_argument(
        "--ingest", default="rgb",
        choices=["rgb", "yuv420", "dct420", "dct420s"],
        help="upload format; only rgb is ported",
    )
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return ap


def list_inputs(path: str) -> list[str]:
    """Resolve an image file or folder; fail fast before any model loads."""
    exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
    if os.path.isfile(path):
        return [path]
    if not os.path.isdir(path):
        raise SystemExit(f"error: input path does not exist: {path}")
    files = sorted(
        os.path.join(path, f)
        for f in os.listdir(path)
        if f.lower().endswith(exts)
    )
    if not files:
        raise SystemExit(f"error: no images found in {path}")
    return files
