"""PyTorch / CUDA port of facedet_tpu: SAHI sliced face detection with
YOLOv11-pose on an NVIDIA H100.

The package imports torch, numpy and PIL, never jax or facedet_tpu. Its
entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""
from facedet_tpu_torch.core.detections import Detections
from facedet_tpu_torch.engine.detector import DetectionModel, YoloV11PoseDetectionModel
from facedet_tpu_torch.engine.predict import get_prediction, get_sliced_prediction
from facedet_tpu_torch.engine.prediction import ObjectPrediction, PredictionResult

__all__ = [
    "Detections",
    "DetectionModel",
    "YoloV11PoseDetectionModel",
    "get_prediction",
    "get_sliced_prediction",
    "ObjectPrediction",
    "PredictionResult",
]
