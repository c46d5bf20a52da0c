"""Typed configuration layer.

The reference has three uncoordinated config styles — argparse, hardcoded
CONFIG dicts per script, and generated JSON artifacts (SURVEY.md §5 /
eval/eval_official_widerface.py:500-518, pipeline_v4_yolo/app_yolo_sahi.py:121-140,
utils/tuning_sahi.py:283-288). This module unifies them: dataclasses with
JSON round-trip serving the CLI apps, evaluators, and tuner. The tuner's
``best_sahi_config.json`` loads directly into ``SliceConfig``/``PostprocessConfig``.
A copy of facedet_tpu/utils/config.py.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class SliceConfig:
    slice_height: Optional[int] = 640
    slice_width: Optional[int] = 640
    overlap_height_ratio: float = 0.2
    overlap_width_ratio: float = 0.2
    perform_standard_pred: bool = True
    auto_slice_resolution: bool = True
    policy: str = "fixed"  # fixed | half_image | fixed_grid | resolution_bucketed


@dataclasses.dataclass
class PostprocessConfig:
    postprocess_type: str = "GREEDYNMM"
    postprocess_match_metric: str = "IOS"
    postprocess_match_threshold: float = 0.5
    postprocess_class_agnostic: bool = False


@dataclasses.dataclass
class DetectorConfig:
    family: str = "yolov11"  # yolov11 | scrfd | rtdetr | onnx | fake
    variant: Optional[str] = None  # rtdetr: a preset (rtdetr-l by default) or rtdetr-l-hgnetv2
    scale: str = "s"
    model_path: Optional[str] = None
    confidence_threshold: float = 0.3
    image_size: int = 640
    dtype: str = "bfloat16"
    max_detections_per_tile: int = 300


@dataclasses.dataclass
class EnhancerConfig:
    enabled: bool = False
    model_name: str = "RealESRGAN_x4plus"
    model_path: Optional[str] = None
    outscale: float = 4.0
    tile: int = 400
    tile_pad: int = 10
    half: bool = True


@dataclasses.dataclass
class PipelineConfig:
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    slicing: SliceConfig = dataclasses.field(default_factory=SliceConfig)
    postprocess: PostprocessConfig = dataclasses.field(default_factory=PostprocessConfig)
    enhancer: EnhancerConfig = dataclasses.field(default_factory=EnhancerConfig)
    input_dir: str = "data/input"
    output_dir: str = "data/output"

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(dataclasses.asdict(self), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    @staticmethod
    def from_json(path_or_str: str) -> "PipelineConfig":
        try:
            data = json.loads(path_or_str)
        except (json.JSONDecodeError, ValueError):
            with open(path_or_str) as f:
                data = json.load(f)
        return PipelineConfig(
            detector=DetectorConfig(**data.get("detector", {})),
            slicing=SliceConfig(**data.get("slicing", {})),
            postprocess=PostprocessConfig(**data.get("postprocess", {})),
            enhancer=EnhancerConfig(**data.get("enhancer", {})),
            input_dir=data.get("input_dir", "data/input"),
            output_dir=data.get("output_dir", "data/output"),
        )


def load_best_sahi_config(path: str) -> tuple[SliceConfig, PostprocessConfig]:
    """Consume the tuner's ``best_sahi_config.json`` artifact
    (reference utils/tuning_sahi.py:283-288)."""
    with open(path) as f:
        best = json.load(f)
    sc = SliceConfig(
        slice_height=best.get("slice_size", 640),
        slice_width=best.get("slice_size", 640),
        overlap_height_ratio=best.get("overlap", 0.2),
        overlap_width_ratio=best.get("overlap", 0.2),
    )
    pc = PostprocessConfig(
        postprocess_type=best.get("postprocess", "GREEDYNMM"),
        postprocess_match_metric=best.get("metric", "IOS"),
        postprocess_match_threshold=best.get("threshold", 0.5),
    )
    return sc, pc
