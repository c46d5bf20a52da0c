"""PyTorch / CUDA port of facedet_tpu: SAHI sliced face detection with
YOLOv11-pose, SCRFD, RT-DETR or an imported ONNX graph, and Real-ESRGAN
super-resolution on an NVIDIA H100.

The package imports torch, numpy and PIL, never jax or facedet_tpu. Its
entry points run on the CUDA device unless the caller passes
``device="cpu"``. The serving path is ``predict_stream_batched`` over
``input_format="dct420s"`` (engine/predict.py); enhancement is
``FaceEnhancer`` (engine/enhancer.py) and the two composed pipelines of
engine/pipelines.py. The other detector families live in
engine/scrfd_wrapper.py, engine/rtdetr_wrapper.py, engine/onnx_wrapper.py and
engine/fake.py; apps/common.build_detector builds all five. The WIDERFACE
evaluators, the SAHI tuner and the image-quality metrics (NIQE, BRISQUE,
TOPIQ's CFANet in models/topiq.py) live in eval/.
"""
from facedet_tpu_torch.core.detections import Detections
from facedet_tpu_torch.engine.detector import DetectionModel, YoloV11PoseDetectionModel
from facedet_tpu_torch.engine.enhancer import FaceEnhancer, enhance_face_crops_batch
from facedet_tpu_torch.engine.predict import (
    get_prediction,
    get_sliced_prediction,
    get_sliced_prediction_batch,
    predict_stream,
    predict_stream_batched,
)
from facedet_tpu_torch.engine.prediction import ObjectPrediction, PredictionResult

__all__ = [
    "Detections",
    "DetectionModel",
    "YoloV11PoseDetectionModel",
    "FaceEnhancer",
    "enhance_face_crops_batch",
    "get_prediction",
    "get_sliced_prediction",
    "get_sliced_prediction_batch",
    "predict_stream",
    "predict_stream_batched",
    "ObjectPrediction",
    "PredictionResult",
    "predict",
]


def predict(*args, **kwargs):
    """Batch prediction over a folder, an image or a COCO file (lazy import;
    see engine/batch_predict.py)."""
    from facedet_tpu_torch.engine.batch_predict import predict as _predict

    return _predict(*args, **kwargs)
