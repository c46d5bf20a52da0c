"""Shared CLI plumbing for the port's apps (counterpart of
facedet_tpu/apps/common.py). ``build_detector`` builds the five detector
families (yolov11, scrfd, rtdetr, onnx, fake); it and ``build_enhancer`` take
the torch device, ``cuda`` by default."""
from __future__ import annotations

import argparse
import os

from facedet_tpu_torch.utils.config import DetectorConfig, EnhancerConfig


def build_detector(cfg: DetectorConfig, device: str = "cuda"):
    if cfg.family == "fake":
        # deterministic blob detector (engine/fake.py): lets every CLI run
        # end to end without weights
        from facedet_tpu_torch.engine.fake import FakeBlobDetectionModel

        return FakeBlobDetectionModel(
            confidence_threshold=cfg.confidence_threshold,
            image_size=cfg.image_size,
            device=device,
        )
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
    if cfg.family == "scrfd":
        from facedet_tpu_torch.engine.scrfd_wrapper import ScrfdDetectionModel

        return ScrfdDetectionModel(
            model_path=cfg.model_path,
            confidence_threshold=cfg.confidence_threshold,
            image_size=cfg.image_size,
            dtype=cfg.dtype,
            device=device,
        )
    if cfg.family == "rtdetr":
        from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel

        return RtDetrDetectionModel(
            model_path=cfg.model_path,
            variant=cfg.variant or "rtdetr-l",
            confidence_threshold=cfg.confidence_threshold,
            image_size=cfg.image_size,
            dtype=cfg.dtype,
            device=device,
        )
    if cfg.family == "onnx":
        # any exported ultralytics YOLO/RT-DETR .onnx (engine/onnx_wrapper.py)
        from facedet_tpu_torch.engine.onnx_wrapper import OnnxDetectionModel

        return OnnxDetectionModel(
            model_path=cfg.model_path,
            confidence_threshold=cfg.confidence_threshold,
            image_size=cfg.image_size,
            max_detections_per_tile=cfg.max_detections_per_tile,
            device=device,
        )
    raise ValueError(f"unknown detector family {cfg.family!r}")


def build_enhancer(cfg: EnhancerConfig, device: str = "cuda"):
    from facedet_tpu_torch.engine.enhancer import FaceEnhancer

    return FaceEnhancer(
        model_name=cfg.model_name,
        model_path=cfg.model_path,
        outscale=cfg.outscale,
        tile=cfg.tile,
        tile_pad=cfg.tile_pad,
        half=cfg.half,
        device=device,
    )


def base_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--input", default="data/input", help="image file or folder")
    ap.add_argument("--output", default="data/output")
    ap.add_argument("--model-path", default=None, help=".npz checkpoint of the JAX package, or .onnx")
    ap.add_argument(
        "--family", default="yolov11",
        choices=["yolov11", "scrfd", "rtdetr", "onnx", "fake"],
    )
    ap.add_argument("--scale", default="s", help="yolo model scale n/s/m/l/x")
    ap.add_argument("--variant", default=None,
                    help="rtdetr variant: rtdetr-l (the default preset) or rtdetr-l-hgnetv2 (the published RT-DETR-l)")
    ap.add_argument("--conf", type=float, default=0.3)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--slice", type=int, default=640)
    ap.add_argument("--overlap", type=float, default=0.2)
    ap.add_argument("--config", default=None, help="PipelineConfig json path")
    ap.add_argument(
        "--ingest", default="rgb",
        choices=["rgb", "yuv420", "dct420", "dct420s"],
        help="host-to-device upload format",
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
