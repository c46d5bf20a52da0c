"""Detector model abstraction — the port's ``DetectionModel`` family.

Counterpart of facedet_tpu/engine/detector.py. The compute contract is
tensor-first: ``tile_forward(tiles) -> Detections`` runs a whole SAHI tile
batch (NHWC in [0, 1], the JAX layout) through the detector and the
per-tile decode; ``tile_forward_nchw`` is the same on NCHW tiles, which the
sliced pipeline gathers directly. The Python-object API
(``perform_inference``, ``convert_original_predictions``,
``object_prediction_list``) is the compatibility edge.

Device: ``device=None`` means ``"cuda"``. Without a CUDA device the
constructor raises unless the caller asked for ``device="cpu"``; nothing
falls back to the CPU on its own.

Weights: ``model_path`` is a ``.npz`` of flat flax variables (the JAX
package's checkpoints, carried over by models/from_jax.py; an int8 tree of
models/quantize.py too), an ultralytics ``.pt`` (models/convert.py) or
``None`` for a random init from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import contextlib
import copy
import os
from typing import Any, Optional

import numpy as np
import torch

from facedet_tpu_torch.core.detections import Detections
from facedet_tpu_torch.core.letterbox import (
    apply_letterbox,
    compute_letterbox,
    unletterbox_boxes,
    unletterbox_kpts,
)
from facedet_tpu_torch.engine.prediction import detections_to_object_predictions
from facedet_tpu_torch.models.init import random_init as _random_init
from facedet_tpu_torch.utils.profiling import SPANS

DEFAULT_CATEGORY_MAPPING = {"0": "face"}


def save_params_npz(path: str, variables: dict, half: bool = False) -> None:
    """Nested variables (flax's ``{"params": ..., "batch_stats": ...}``,
    numpy arrays, as models/from_jax.to_jax_variables builds them) -> a flat
    ``a/b/c`` ``.npz``, the format both packages load. ``half=True`` stores
    float32 as float16, compressed (checkpoints kept as assets)."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            arr = np.asarray(node)
            flat[prefix] = arr.astype(np.float16) if half and arr.dtype == np.float32 else arr

    walk(variables, "")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    (np.savez_compressed if half else np.savez)(path, **flat)


def resolve_device(device) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the CPU"
        )
    return dev


def _tensors_to(tree, device):
    """A nested dict with every tensor leaf copied to ``device``."""
    if isinstance(tree, dict):
        return {k: _tensors_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class DetectionModel:
    """Base detector. Subclasses implement ``load_model`` and
    ``tile_forward_nchw``."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        device=None,
        confidence_threshold: float = 0.3,
        category_mapping: Optional[dict] = None,
        image_size: Optional[int] = None,
        load_at_init: bool = True,
        max_detections_per_tile: int = 300,
        **kwargs: Any,
    ):
        self.model_path = model_path
        self.device = resolve_device(device)
        self.confidence_threshold = confidence_threshold
        self.category_mapping = category_mapping or dict(DEFAULT_CATEGORY_MAPPING)
        self.image_size = image_size
        self.max_detections_per_tile = max_detections_per_tile
        self.model: Any = None
        self._original_predictions: Optional[Detections] = None
        self._object_prediction_list: list = []
        self.durations_in_seconds: dict[str, float] = {}
        if load_at_init:
            self.load_model()

    @property
    def num_keypoints(self) -> int:
        return 5

    def load_model(self) -> None:
        raise NotImplementedError

    def unload_model(self) -> None:
        self.model = None

    def replica(self, device) -> "DetectionModel":
        """A copy of the detector whose weights lie on ``device``: the
        ``nn.Module`` deep-copied there, and every tensor of ``variables``
        (the ONNX route keeps its weights there, engine/onnx_wrapper.py)
        copied there. Everything else is shared with this detector."""
        rep = copy.copy(self)
        rep.device = resolve_device(device)
        if isinstance(self.model, torch.nn.Module):
            rep.model = copy.deepcopy(self.model).to(rep.device)
        if isinstance(getattr(self, "variables", None), dict):
            rep.variables = _tensors_to(self.variables, rep.device)
        return rep

    def tile_forward_nchw(self, tiles: torch.Tensor, conf_threshold: float) -> Detections:
        """tiles [T,3,S,S] float in [0,1] on ``self.device`` -> per-tile
        Detections [T, k]."""
        raise NotImplementedError

    def tile_forward(self, tiles: torch.Tensor, conf_threshold: float) -> Detections:
        """tiles [T,S,S,3] float in [0,1] -> per-tile Detections [T, k]."""
        return self.tile_forward_nchw(tiles.permute(0, 3, 1, 2), conf_threshold)

    def forward_tiles(self, tiles, conf_threshold: float | None = None) -> Detections:
        """``tile_forward`` at the model's confidence threshold, with the
        tiles moved to the model's device."""
        conf = self.confidence_threshold if conf_threshold is None else conf_threshold
        return self.tile_forward(torch.as_tensor(tiles).to(self.device), float(conf))

    # --- host-side compatibility edge ---------------------------------
    def perform_inference(self, image) -> None:
        """Single image/tile inference: letterbox to ``image_size``, forward,
        map back; stores the raw predictions on self. ``image`` is HWC, a
        numpy array or a tensor, which goes to the model's device as it is
        and is letterboxed there. The call is an ``inference`` span of
        ``utils.profiling.SPANS``, whose length is
        ``durations_in_seconds["prediction"]``."""
        with SPANS.span("inference") as span:
            if isinstance(image, torch.Tensor):
                img = image.to(self.device)
                if img.dtype == torch.uint8:
                    img = img.to(torch.float32) / 255.0
            else:
                img = np.asarray(image)
                if img.dtype == np.uint8:
                    img = img.astype(np.float32) / 255.0
                img = torch.from_numpy(img).to(self.device)
            size = self.image_size or max(img.shape[:2])
            spec = compute_letterbox(img.shape[0], img.shape[1], int(size))
            tile = apply_letterbox(img, spec)
            det = self.forward_tiles(tile[None]).map(lambda x: x[0])
            self._original_predictions = Detections(
                boxes=unletterbox_boxes(det.boxes, spec),
                scores=det.scores,
                classes=det.classes,
                kpts=unletterbox_kpts(det.kpts, spec),
                valid=det.valid,
            )
        self.durations_in_seconds["prediction"] = span.seconds

    @property
    def original_predictions(self) -> Optional[Detections]:
        return self._original_predictions

    def convert_original_predictions(
        self,
        shift_amount: tuple[int, int] = (0, 0),
        full_shape: Optional[tuple[int, int]] = None,
    ) -> None:
        """Raw tensor predictions -> shifted/clipped ObjectPrediction list."""
        det = self._original_predictions
        if det is None:
            raise RuntimeError("perform_inference must be called first")
        det = det.to("cpu")
        sx, sy = float(shift_amount[0]), float(shift_amount[1])
        boxes = det.boxes.numpy() + np.array([sx, sy, sx, sy], np.float32)
        kpts = det.kpts.numpy().copy()
        kpts[..., 0] += sx
        kpts[..., 1] += sy
        valid = det.valid.numpy() & (det.scores.numpy() >= self.confidence_threshold)
        if full_shape is not None:
            h, w = full_shape
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
            valid &= (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        shifted = Detections(
            boxes=torch.from_numpy(boxes),
            scores=det.scores,
            classes=det.classes,
            kpts=torch.from_numpy(kpts),
            valid=torch.from_numpy(valid),
        )
        self._object_prediction_list = detections_to_object_predictions(
            shifted, self.category_mapping, full_shape
        )

    @property
    def object_prediction_list(self) -> list:
        return self._object_prediction_list

    @property
    def object_prediction_list_per_image(self) -> list[list]:
        return [self._object_prediction_list]


def attach_keypoints_to_predictions(predictions, keypoint_cache=None, iou_threshold=0.5):
    """The reference's post-merge keypoint re-attachment
    (utils/yolo_wrapper.py:168-200), as the JAX package keeps it: keypoints
    ride through the merge as tensor columns, so this only fills a
    prediction whose ``keypoints`` is None from ``keypoint_cache``
    ({(x1, y1, x2, y2): kpts}), by the exact key of its box rounded to 0.1
    first, then by the first cached box of IoU over ``iou_threshold``
    (``eval/dual.calculate_iou``). Returns ``predictions``, filled in place."""
    if not keypoint_cache:
        return predictions
    from facedet_tpu_torch.eval.dual import calculate_iou

    for p in predictions:
        if p.keypoints is not None:
            continue
        box = tuple(round(v, 1) for v in p.bbox.to_xyxy())
        if box in keypoint_cache:
            p.keypoints = np.asarray(keypoint_cache[box], np.float32)
            continue
        x1, y1, x2, y2 = p.bbox.to_xyxy()
        for (kx1, ky1, kx2, ky2), kpts in keypoint_cache.items():
            if calculate_iou([x1, y1, x2 - x1, y2 - y1], [kx1, ky1, kx2 - kx1, ky2 - ky1]) > iou_threshold:
                p.keypoints = np.asarray(kpts, np.float32)
                break
    return predictions


@contextlib.contextmanager
def _exact_float32(on: bool):
    """Turn TF32 off for cuBLAS and cuDNN while ``on`` (the float32 fidelity
    mode): cuDNN runs float32 convs in TF32 by default, which keeps about
    three decimal digits. The previous settings are restored on exit."""
    if not on:
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class YoloV11PoseDetectionModel(DetectionModel):
    """YOLOv11-pose detector, with keypoints carried through the merge as
    tensor columns.

    ``dtype="bfloat16"`` is the serving dtype and ``"float32"`` the fidelity
    mode; ``bn_dtype`` follows ``dtype`` unless given. ``s2d_early`` is
    accepted for signature parity and ignored: the JAX package's
    space-to-depth rewrite computes the same function."""

    def attach_keypoints_to_predictions(self, predictions, iou_threshold=0.5):
        """The reference's method (utils/yolo_wrapper.py:168): a pass-through,
        as in the JAX package, for keypoints survive the merge here."""
        return attach_keypoints_to_predictions(predictions, None, iou_threshold)

    def __init__(
        self,
        *args,
        scale: str = "s",
        dtype: str = "bfloat16",
        bn_dtype: str | None = None,
        s2d_early: bool = True,
        seed: int = 0,
        **kwargs,
    ):
        self.scale = scale
        self.dtype = dtype
        self.bn_dtype = bn_dtype or ("bfloat16" if dtype == "bfloat16" else "float32")
        self.s2d_early = s2d_early
        self.seed = seed
        super().__init__(*args, **kwargs)

    def load_model(self) -> None:
        self.model = self.float32_model().set_dtypes().to(self.device).eval()

    def float32_model(self):
        """The model as its checkpoint (or seed) gives it: float32 on the
        CPU, before ``set_dtypes`` casts its convs to the compute dtype.
        models/quantize.py quantizes a bfloat16 detector's kernels from it."""
        from facedet_tpu_torch.models.from_jax import load_jax_variables, load_params_npz
        from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11

        self.cfg = YoloConfig(
            scale=self.scale,
            num_classes=len(self.category_mapping),
            with_pose=True,
            dtype=self.dtype,
            bn_dtype=self.bn_dtype,
        )
        model = YoloV11(self.cfg)
        if self.model_path is None:
            _random_init(model, self.seed)
        elif str(self.model_path).endswith(".npz"):
            load_jax_variables(model, load_params_npz(self.model_path))
        elif str(self.model_path).endswith(".pt"):
            from facedet_tpu_torch.models.convert import convert_ultralytics_checkpoint
            from facedet_tpu_torch.models.from_jax import _load_strict

            state, _scale = convert_ultralytics_checkpoint(self.model_path, self.cfg)
            _load_strict(model, state)
        else:
            raise ValueError(f"unsupported checkpoint format: {self.model_path}")
        return model

    def tile_forward_nchw(self, tiles: torch.Tensor, conf_threshold: float) -> Detections:
        from facedet_tpu_torch.models.yolo_decode import decode_predictions, decode_to_detections

        with torch.inference_mode(), _exact_float32(self.dtype == "float32"):
            preds = decode_predictions(self.model.forward_nchw(tiles))
            return decode_to_detections(
                preds,
                conf_threshold=conf_threshold,
                max_detections=self.max_detections_per_tile,
                nms_iou=0.7,
                class_agnostic=True,
            )
