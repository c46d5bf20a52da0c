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

CUDA graphs: on the card, ``YoloV11PoseDetectionModel.tile_forward_nchw``
replays its pre-NMS chain (the forward, the decode and the top-k) from one
``torch.cuda.CUDAGraph`` per tile shape (``ForwardGraphs``), and runs the
per-tile NMS, whose rounds read back to the host, eagerly on the graph's
outputs. ``RtDetrDetectionModel`` (engine/rtdetr_wrapper.py) replays its
whole chain the same way; it runs no NMS.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import os
import threading
from typing import Any, Callable, Optional

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


def graph_key(tiles: torch.Tensor, conf_threshold: float, max_detections: int) -> tuple:
    """What a captured pre-NMS chain bakes in: the tiles' shape, strides,
    dtype and device, the confidence threshold and the top-k's size."""
    return (tuple(tiles.shape), tiles.stride(), tiles.dtype, tiles.device, float(conf_threshold),
            int(max_detections))


class _Graph:
    """One captured chain: its static input, the graph, its static outputs,
    and the counters the captured chain added (``SPANS.add``), which each
    replay adds again."""

    def __init__(self, graph, tiles: torch.Tensor, out, counts: dict):
        self.graph, self.tiles, self.out, self.counts = graph, tiles, out, counts

    def __call__(self, tiles: torch.Tensor):
        self.tiles.copy_(tiles)
        self.graph.replay()
        return self.out


class ForwardGraphs:
    """The CUDA graphs of one detector's pre-NMS chain, by ``graph_key``.

    A key's first call warms the chain up eagerly on a side stream (cuDNN's
    plans, the allocator's growth, cuBLAS's workspace on that stream),
    captures it there into the detector's one memory pool with
    ``capture_error_mode="thread_local"`` (another thread may be copying on
    its own stream meanwhile), then replays it; later calls copy the tiles
    into the static input and replay. A key whose capture raises runs
    eagerly for the life of the cache. At most ``MAX_KEYS`` graphs are
    kept: the least recently used is dropped, which frees it. All graphs
    hold the weights of one model by pointer, so a call for another model
    object empties the cache first, and the owner empties it where it
    replaces modules inside its model.

    What the chain counts through ``SPANS.add`` (the BatchNorm epilogues of
    ``ops/kernels/bn_act.py``) goes into the call's ``detector`` span once a
    call: an eager run counts itself; a capture keeps the counts of the
    captured run alone (``SPANS.tally``), and the capture's first replay and
    every later one add them, for no Python runs in a replay. A capture is a
    graph with a ``counts`` dict.

    ``__call__`` holds ``lock`` until the caller's ``post`` returns, for
    the graph's outputs are overwritten by its next replay; ``post`` must
    return tensors of its own. A copy or a pickle of the cache is a new,
    empty one."""

    MAX_KEYS = 8

    def __init__(self, capture: Optional[Callable] = None):
        self.lock = threading.Lock()
        self._capture = capture or self._capture_cuda
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._eager: set = set()
        self._model = None
        self._pool = None

    def __reduce__(self):
        return ForwardGraphs, ()

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> list:
        """The kept keys, least recently used first."""
        return list(self._graphs)

    def clear(self) -> None:
        self._graphs.clear()
        self._eager.clear()
        self._model = None

    def __call__(self, model, pre: Callable, tiles: torch.Tensor, key: Optional[tuple], post: Callable,
                 counts: Optional[dict] = None):
        """``post(pre(tiles))``, ``pre`` run inside a ``detector`` span of
        ``SPANS`` that counts one of ``graph_replays`` (replayed),
        ``graph_captures`` (captured, then replayed) or ``graph_eager`` (run
        eagerly: ``key`` is None, or its capture failed), and the caller's
        own ``counts`` ({counter: n}, known on the host). ``model`` is the
        module whose weights ``pre`` reads."""
        with self.lock:
            with SPANS.span("detector") as span:
                for name, n in (counts or {}).items():
                    span.add(name, n)
                out = self._pre(model, pre, tiles, key, span)
            return post(out)

    def _pre(self, model, pre, tiles, key, span):
        if key is not None and model is not self._model:
            self.clear()
            self._model = model
        if key is None or key in self._eager:
            span.add("graph_eager")
            return pre(tiles)
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            span.add("graph_replays")
            return self._replay(graph, tiles, span)
        try:
            with SPANS.tally():  # the capture's own runs
                graph = self._capture(pre, tiles)
        except RuntimeError:
            self._eager.add(key)
            span.add("graph_eager")
            return pre(tiles)
        self._graphs[key] = graph
        if len(self._graphs) > self.MAX_KEYS:
            self._graphs.popitem(last=False)
        span.add("graph_captures")
        return self._replay(graph, tiles, span)

    @staticmethod
    def _replay(graph, tiles, span):
        for name, n in graph.counts.items():
            span.add(name, n)
        return graph(tiles)

    def _capture_cuda(self, pre: Callable, tiles: torch.Tensor) -> _Graph:
        device = tiles.device
        with torch.cuda.device(device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            current, side = torch.cuda.current_stream(device), torch.cuda.Stream(device)
            static = torch.empty_like(tiles).copy_(tiles)
            side.wait_stream(current)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                pre(static)
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    with SPANS.tally() as counts:
                        out = pre(static)
                finally:
                    graph.capture_end()
            current.wait_stream(side)
        return _Graph(graph, static, out, counts)


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
        self.forward_graphs = ForwardGraphs()
        if load_at_init:
            self.load_model()

    @property
    def num_keypoints(self) -> int:
        return 5

    def load_model(self) -> None:
        raise NotImplementedError

    def unload_model(self) -> None:
        self.model = None
        self.forward_graphs.clear()

    def replica(self, device) -> "DetectionModel":
        """A copy of the detector whose weights lie on ``device``: the
        ``nn.Module`` deep-copied there, and every tensor of ``variables``
        (the ONNX route keeps its weights there, engine/onnx_wrapper.py)
        copied there, with no CUDA graph of its own yet. Everything else is
        shared with this detector."""
        rep = copy.copy(self)
        rep.device = resolve_device(device)
        rep.forward_graphs = ForwardGraphs()
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
        self.forward_graphs.clear()

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
        """The forward, the decode and the top-k (``decode_to_detections``
        without its NMS), then the per-tile IoU NMS. On the card, with the
        model in eval mode and no capture under way, the chain before the
        NMS is replayed from ``forward_graphs``, one CUDA graph per
        ``graph_key``; elsewhere it runs eagerly. Captured inside
        ``_exact_float32``, so the float32 mode replays TF32-off kernels."""
        from facedet_tpu_torch.models.yolo_decode import decode_predictions, decode_to_detections
        from facedet_tpu_torch.ops.nms import nms

        def pre(x):
            return decode_to_detections(decode_predictions(self.model.forward_nchw(x)),
                                        conf_threshold=conf_threshold,
                                        max_detections=self.max_detections_per_tile, with_nms=False)

        key = None
        if tiles.is_cuda and not self.model.training and not torch.cuda.is_current_stream_capturing():
            key = graph_key(tiles, conf_threshold, self.max_detections_per_tile)
        with torch.inference_mode(), _exact_float32(self.dtype == "float32"):
            return self.forward_graphs(self.model, pre, tiles, key,
                                       lambda det: nms(det, iou_threshold=0.7, class_agnostic=True))
