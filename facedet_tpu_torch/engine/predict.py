"""Sliced and standard prediction drivers — the port's public inference API.

Counterpart of facedet_tpu/engine/predict.py: ``get_prediction``,
``get_sliced_prediction``, ``get_sliced_prediction_batch``,
``predict_stream`` and ``predict_stream_batched``, for the input formats
``rgb``, ``yuv420``, ``dct420`` and ``dct420s``. The sliced pipeline is the
JAX package's fused ``core`` / ``batch_core``, run eagerly on the model's
device: decode the uploaded planes into a zero-padded bucketed CHW canvas in
[0, 1] -> tile gather (the CHW CUDA kernel of ops/kernels/tile_gather.py,
straight into the NCHW batch the convs take; one launch for a whole chunk of
images) -> detector forward over the tile batch (+ the letterboxed
full-image standard pass) -> slice-to-global shift -> truncate ->
GreedyNMM/NMS merge -> clip -> optional fetch compaction -> copy to the host.

Where JAX dispatches asynchronously, this module uses CUDA streams: a batch
is staged into pinned host memory, uploaded on a copy stream, computed on the
dispatching thread's stream after an event wait, and its result copied into
pinned memory behind an event that only the consumer waits on.

Several devices (parallel/): ``get_sliced_prediction(mesh=)`` runs SPMD,
one process per device of a ``torch.distributed`` ``DeviceMesh``: every rank
calls it with the same image, the tile batch is split over the mesh's
``tile`` ranks and the per-tile detections all-gathered
(``parallel.sharding.shard_tile_batch_forward``), and the standard pass and
the merge run replicated, so every rank returns the same result.
``predict_stream_batched(devices=[...])`` round-robins whole batches over a
list of devices from one process, with a replica of the detector on each and
no collective.
"""
from __future__ import annotations

import contextlib
import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from facedet_tpu_torch.core.boxes import clip_boxes
from facedet_tpu_torch.core.detections import Detections, concat_detections
from facedet_tpu_torch.engine.detector import DetectionModel, _exact_float32, resolve_device
from facedet_tpu_torch.engine.prediction import PredictionResult, detections_to_object_predictions
from facedet_tpu_torch.ops.color import rgb_to_yuv420, yuv420_to_rgb_chw, yuv420_to_rgb_np
from facedet_tpu_torch.ops.image import scale_and_translate_chw
from facedet_tpu_torch.ops.jpeg_dct import (
    DctImage,
    _wire_sections,
    decode_dct420_np,
    decode_dct420_to_yuv_f32,
    encode_dct420,
    pack_sparse_ac_batch,
    unpack_sparse_ac,
    wire_unpack_dct420s,
)
from facedet_tpu_torch.ops.kernels.tile_gather import gather_tiles_chw
from facedet_tpu_torch.ops.nms import merge_detections
from facedet_tpu_torch.ops.tiler import (
    adaptive_slice_size,
    bucket_image_dim,
    bucket_tile_count,
    compute_slice_grid,
    pad_grid_offsets,
)
from facedet_tpu_torch.utils.profiling import SPANS

__all__ = [
    "get_prediction",
    "get_sliced_prediction",
    "get_sliced_prediction_batch",
    "predict_stream",
    "predict_stream_batched",
    "POSTPROCESS_DEFAULTS",
    "INPUT_FORMATS",
]

POSTPROCESS_DEFAULTS = {
    "postprocess_type": "GREEDYNMM",
    "postprocess_match_metric": "IOS",
    "postprocess_match_threshold": 0.5,
    "postprocess_class_agnostic": False,
}
INPUT_FORMATS = ("rgb", "yuv420", "dct420", "dct420s")

# batch_core runs the detector over chunks of c images with c*T tiles at most
_MAX_FLAT_TILES = 96


# --- the device pipeline ------------------------------------------------------


def _shift_and_flatten(det: Detections, offsets: torch.Tensor, tile_valid: torch.Tensor) -> Detections:
    """Per-tile detections [..., T, k] -> flat global-coordinate detections
    [..., T*k]."""
    off_xy = offsets.to(torch.float32).flip(-1)  # (y,x) -> (x,y)
    boxes = det.boxes + off_xy.repeat(1, 2)[:, None, :]
    kpts = det.kpts.clone()
    kpts[..., :2] += off_xy[:, None, None, :]
    valid = det.valid & tile_valid[:, None]
    lead = valid.shape[:-2]
    return Detections(
        boxes=boxes.reshape(*lead, -1, 4),
        scores=det.scores.reshape(*lead, -1),
        classes=det.classes.reshape(*lead, -1),
        kpts=kpts.reshape(*lead, -1, det.kpts.shape[-2], 3),
        valid=valid.reshape(*lead, -1),
    )


def _truncate_by_score(det: Detections, capacity: int) -> Detections:
    return det.sort_by_score().truncate(capacity)


def _clip_detections(det: Detections, h: int, w: int) -> Detections:
    boxes = clip_boxes(det.boxes, h, w)
    # drop boxes that clipping degenerated to zero area (fully outside image)
    nonzero = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    return Detections(
        boxes=boxes,
        scores=det.scores,
        classes=det.classes,
        kpts=det.kpts,
        valid=det.valid & nonzero,
    )


def letterbox_full(canvas_chw: torch.Tensor, true_hw: torch.Tensor, img_size: int):
    """The standard pass's input: ``jax.image.scale_and_translate`` of the
    padded canvas (antialiased linear, translation 0) into a top-left-aligned
    ``img_size``² image, at the scale of the true image size. Samples past
    the canvas get weight 0: there is no centred grey pad. A batch of
    canvases [B,C,H,W] shares one true size, so one scale. Returns
    ([..., C, img_size, img_size], float32 scale)."""
    scale = torch.minimum(img_size / true_hw[0], img_size / true_hw[1])
    return scale_and_translate_chw(canvas_chw, img_size, img_size, scale), scale


def _canvas_dtype(detection_model) -> torch.dtype:
    """The canvas is kept in the detector's compute dtype, as in the JAX
    engine: bfloat16 for serving, float32 for the fidelity mode."""
    return torch.bfloat16 if getattr(detection_model, "dtype", "") == "bfloat16" else torch.float32


def decode_canvas(image, input_format: str, bucket_h: int, bucket_w: int, dtype: torch.dtype) -> torch.Tensor:
    """Uploaded planes (already padded to the bucket on the host) -> the CHW
    canvas [..., 3, bucket_h, bucket_w] in [0, 1], in ``dtype``. Every format
    takes any number of leading batch axes.

    * ``rgb``: an HWC image, uint8 or float in [0, 1];
    * ``yuv420``: (Y, UV) uint8 planes: chroma upsample and BT.601
      conversion on the device (ops/color.py);
    * ``dct420``: (y_dc, y_ac, uv_dc, uv_ac, qy, qc) with the AC planes in
      wire layout (coefficient-major, as ``_stage_batch_host`` stages them),
      transposed back here next to the IDCT products (ops/jpeg_dct.py);
    * ``dct420s``: (y_dc, uv_dc, qy, qc, deltas, vals), the sparse AC wire,
      rebuilt by a cumsum and a scatter into the same wire-layout planes."""
    if input_format == "rgb":
        chw = image.movedim(-1, -3).contiguous()
        return chw.to(dtype) / 255.0 if chw.dtype == torch.uint8 else chw.to(dtype)
    if input_format == "yuv420":
        y, uv = image
        return yuv420_to_rgb_chw(y, uv, out_dtype=dtype)
    if input_format == "dct420":
        y_dc, y_ac, uv_dc, uv_ac, qy, qc = image
    elif input_format == "dct420s":
        y_dc, uv_dc, qy, qc, deltas, vals = image
        yb_h, yb_w = bucket_h // 8, bucket_w // 8
        cb_h, cb_w = bucket_h // 16, bucket_w // 16
        ny = 64 * yb_h * yb_w
        nc = 2 * 64 * cb_h * cb_w
        flat = unpack_sparse_ac(deltas, vals, ny + nc)
        lead = flat.shape[:-1]
        y_ac = flat[..., :ny].reshape(*lead, 64, yb_h, yb_w)
        uv_ac = flat[..., ny:].reshape(*lead, 2, 64, cb_h, cb_w)
    else:
        raise ValueError(f"unknown input_format {input_format!r}; expected one of {INPUT_FORMATS}")
    y_ac = y_ac.movedim(-3, -1)  # [..., 64, Hb, Wb] -> [..., Hb, Wb, 64]
    uv_ac = uv_ac.movedim((-4, -3), (-2, -1))  # [..., 2, 64, Hb2, Wb2] -> [..., Hb2, Wb2, 2, 64]
    y, uv = decode_dct420_to_yuv_f32(y_dc, y_ac, uv_dc, uv_ac, qy, qc, out_dtype=dtype)
    return yuv420_to_rgb_chw(y, uv, out_dtype=dtype)


def _pipeline(detection_model: DetectionModel, plan: dict, image, consts, forward=None) -> Detections:
    """The fused pipeline on a decoded-on-device input: a chunk of
    same-size images (one leading axis). Returns the merged, clipped and
    compacted detections, still on the device.
    ``forward`` replaces the detector's ``tile_forward_nchw`` over the tile
    batch (the tile-sharded forward of a mesh); the standard pass always
    runs the detector's own. Spans: ``ingest``, ``gather``,
    ``forward.tiles``, ``forward.full`` (the standard pass with its
    letterbox) and ``merge``."""
    offsets, tile_valid, true_hw = consts
    sh, sw = plan["slice_height"], plan["slice_width"]
    conf = plan["conf"]
    with SPANS.span("ingest"):
        canvas = decode_canvas(image, plan["input_format"], plan["bucket_h"], plan["bucket_w"], plan["canvas_dtype"])
    lead = canvas.shape[:-3]
    t = offsets.shape[0]
    with SPANS.span("gather"):
        # one gather launch for the chunk: [c*T, 3, S, S], image-major
        tiles = gather_tiles_chw(canvas, offsets, sh, sw)
    with SPANS.span("forward.tiles"):
        det = (forward or detection_model.tile_forward_nchw)(tiles, conf)
    det = det.map(lambda x: x.reshape(*lead, t, *x.shape[1:]))
    parts = [_shift_and_flatten(det, offsets, tile_valid)]
    if plan["standard"]:
        with SPANS.span("forward.full"):
            full_tiles, scale = letterbox_full(canvas, true_hw, plan["img_size"])
            full = detection_model.tile_forward_nchw(full_tiles.reshape(-1, *full_tiles.shape[-3:]), conf)
        full = full.map(lambda x: x.reshape(*lead, *x.shape[1:]))
        kpts = full.kpts.clone()
        kpts[..., :2] /= scale
        parts.append(Detections(full.boxes / scale, full.scores, full.classes, kpts, full.valid))
    with SPANS.span("merge"):
        combined = concat_detections(parts, plan["merge_capacity"])
        merged = merge_detections(
            combined,
            mode=plan["postprocess_type"],
            match_metric=plan["postprocess_match_metric"],
            match_threshold=plan["postprocess_match_threshold"],
            class_agnostic=plan["postprocess_class_agnostic"],
        )
        merged = _clip_detections(merged, plan["h"], plan["w"])
        fetch = plan["fetch_capacity"]
        if fetch and fetch < plan["merge_capacity"]:
            # serving compaction: only the top rows leave the device
            merged = _truncate_by_score(merged, fetch)
    return merged


def batch_core(detection_model: DetectionModel, plan: dict, batch, consts, forward=None) -> Detections:
    """The batch pipeline over ``n`` same-size images (a single image is a
    batch of one): chunks of ``c`` images with ``c*T`` tiles at most
    ``_MAX_FLAT_TILES``. Per chunk, ingest, gather and merge carry the image
    axis, and the detector runs over the flattened [c*T] tile batch and the
    [c] letterboxed batch. Results do not depend on the chunk size.
    ``batch`` is the uploaded wire buffer (``dct420s``), the plane tuple, or
    the RGB canvas batch; ``forward`` is ``_pipeline``'s."""
    b = plan["n"]
    if plan["input_format"] == "dct420s" and not isinstance(batch, tuple):
        batch = wire_unpack_dct420s(batch, b, plan["bucket_h"], plan["bucket_w"])
    t = consts[0].shape[0]
    # largest divisor of b keeping the flat tile batch within the limit
    c = max(d for d in range(1, b + 1) if b % d == 0 and (d == 1 or d * t <= _MAX_FLAT_TILES))
    outs = []
    for i in range(0, b, c):
        chunk = tuple(a[i : i + c] for a in batch) if isinstance(batch, tuple) else batch[i : i + c]
        outs.append(_pipeline(detection_model, plan, chunk, consts, forward))
    return outs[0] if len(outs) == 1 else Detections.cat_batches(outs)


# --- host side: image kinds, padding, staging -----------------------------------


def _prepare_image(image):
    """A ``DctImage`` (dct420 / dct420s ingest) or ``(Y, UV)`` planes (yuv420
    ingest) pass through; otherwise an HWC RGB image (numpy, PIL or a torch
    tensor, which stays on its device) with gray expanded and alpha dropped."""
    if isinstance(image, DctImage):
        return image
    if isinstance(image, tuple):
        y, uv = image
        if y.ndim != 2 or uv.ndim != 3 or uv.shape[-1] != 2:
            raise ValueError("yuv420 input must be (Y [H,W], UV [h2,w2,2])")
        return image
    img = image if isinstance(image, torch.Tensor) else np.asarray(image)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1) if isinstance(img, np.ndarray) else img[..., None].expand(-1, -1, 3)
    if img.shape[-1] == 4:
        img = img[..., :3]
    return img


def _image_hw(img) -> tuple[int, int]:
    if isinstance(img, DctImage):
        return img.hw
    if isinstance(img, tuple):
        return img[0].shape[0], img[0].shape[1]
    return img.shape[0], img.shape[1]


def _to_yuv_planes(img) -> tuple[np.ndarray, np.ndarray]:
    if isinstance(img, tuple):
        return img
    return rgb_to_yuv420(img)


def _display_image(img) -> np.ndarray:
    """RGB array for result objects (reconstructs YUV/DCT-ingested frames;
    fetches a tensor input)."""
    if isinstance(img, DctImage):  # host-side decode, crop to true size
        h, w = img.hw
        y, uv = decode_dct420_np(img)
        return yuv420_to_rgb_np(y[:h, :w], uv[: (h + 1) // 2, : (w + 1) // 2])
    if isinstance(img, tuple):
        return yuv420_to_rgb_np(img[0], img[1])
    if isinstance(img, torch.Tensor):
        arr = img
        if arr.dtype != torch.uint8:
            # quantised where the tensor lies: the same values as on the
            # host, and a quarter of a float32 image's bytes to fetch
            arr = (arr.float() * 255.0).round().clamp(0, 255).to(torch.uint8)
        return arr.cpu().numpy()
    return img


def _fill_pad(a: np.ndarray, rows: int, cols: int, value, axes=(0, 1)) -> None:
    """Write ``value`` outside the top-left ``rows`` x ``cols`` region of the
    two spatial ``axes`` of ``a`` (the bottom and right padding strips)."""
    bottom = [slice(None)] * a.ndim
    bottom[axes[0]] = slice(rows, None)
    a[tuple(bottom)] = value
    right = [slice(None)] * a.ndim
    right[axes[0]] = slice(0, rows)
    right[axes[1]] = slice(cols, None)
    a[tuple(right)] = value


def _stage_batch_host(imgs: list, input_format: str, bucket_h: int, bucket_w: int, alloc=np.empty):
    """Same-size image batch -> host numpy batch in upload layout.

    Single-copy staging: each image's planes are written straight into
    preallocated batch buffers (a pad-then-stack pays a second full copy),
    for all four ingest formats. ``alloc(shape, dtype)`` provides every
    buffer that is uploaded, uninitialised: the streamed path hands out
    pinned memory. Only the padding strips are filled, so each uploaded byte
    is written once. Returns one uint8 wire buffer (``dct420s``), the plane
    tuple (``yuv420`` / ``dct420``) or one canvas array (``rgb``); the
    arrays equal those of the JAX package's ``_stage_batch_host``."""
    n = len(imgs)
    if input_format in ("dct420", "dct420s"):
        yb_h, yb_w = bucket_h // 8, bucket_w // 8
        cb_h, cb_w = bucket_h // 16, bucket_w // 16
        imgs = [im if isinstance(im, DctImage) else encode_dct420(im) for im in imgs]
        sparse = input_format == "dct420s"
        if sparse:
            # sparse wire: stage each image's AC straight into one flat
            # [n, total] pack buffer (y wire planes then uv, contiguous, the
            # byte order the dense branch uploads), then batch-pack into
            # (position deltas, values) with one shared bucketed cap. The
            # pack buffer is host scratch, not uploaded.
            y_sz = 64 * yb_h * yb_w
            uv_sz = 2 * 64 * cb_h * cb_w
            flat2d = np.zeros((n, y_sz + uv_sz), np.int8)
            y_ac = flat2d[:, :y_sz].reshape(n, 64, yb_h, yb_w)
            uv_ac = flat2d[:, y_sz:].reshape(n, 2, 64, cb_h, cb_w)
            # the small DC / quant-table head sections are copied into the
            # wire once its size is known
            head_alloc = np.empty
        else:
            # AC planes staged directly in wire layout: coefficient-major,
            # each frequency's mostly-zero plane contiguous
            y_ac = alloc((n, 64, yb_h, yb_w), np.int8)
            uv_ac = alloc((n, 2, 64, cb_h, cb_w), np.int8)
            head_alloc = alloc
        y_dc = head_alloc((n, yb_h, yb_w), np.int16)
        uv_dc = head_alloc((n, cb_h, cb_w, 2), np.int16)
        qy = head_alloc((n, 64), np.float32)
        qc = head_alloc((n, 64), np.float32)
        for i, im in enumerate(imgs):
            sy, sx = im.y_dc.shape
            cy_, cx_ = im.uv_dc.shape[:2]
            # black-luma padding (parity with the YUV canvas): DC of a
            # level-shifted black block is -1024 pre-quant
            _fill_pad(y_dc[i], sy, sx, np.int16(round(-1024.0 / float(im.qy[0]))))
            y_dc[i, :sy, :sx] = im.y_dc
            _fill_pad(uv_dc[i], cy_, cx_, 0)
            uv_dc[i, :cy_, :cx_] = im.uv_dc
            if not sparse:
                _fill_pad(y_ac[i], sy, sx, 0, axes=(1, 2))
                _fill_pad(uv_ac[i], cy_, cx_, 0, axes=(2, 3))
            y_ac[i, :, :sy, :sx] = np.moveaxis(im.y_ac, -1, 0)
            uv_ac[i, :, :, :cy_, :cx_] = np.moveaxis(im.uv_ac, (2, 3), (0, 1))
            qy[i] = im.qy
            qc[i] = im.qc
        if not sparse:
            return y_dc, y_ac, uv_dc, uv_ac, qy, qc
        # ONE contiguous upload buffer: the pack writes deltas and values
        # straight into the wire's tail; the head sections are copied in.
        sizes = _wire_sections(n, bucket_h, bucket_w)
        fixed = sum(sizes)
        wire = None

        def alloc_tail(cap):
            nonlocal wire
            wire = alloc((fixed + 3 * n * cap,), np.uint8)
            d = wire[fixed : fixed + 2 * n * cap].view(np.uint16)
            v = wire[fixed + 2 * n * cap :].view(np.int8)
            return d.reshape(n, cap), v.reshape(n, cap)

        pack_sparse_ac_batch(flat2d, alloc=alloc_tail)
        o = np.cumsum([0] + sizes)
        for a, lo, hi in zip((y_dc, uv_dc, qy, qc), o[:-1], o[1:]):
            wire[lo:hi] = a.view(np.uint8).ravel()
        return wire
    if input_format == "yuv420":
        y_b = alloc((n, bucket_h, bucket_w), np.uint8)
        uv_b = alloc((n, bucket_h // 2, bucket_w // 2, 2), np.uint8)
        for i, im in enumerate(imgs):
            y, uv = _to_yuv_planes(im)
            _fill_pad(y_b[i], y.shape[0], y.shape[1], 0)
            y_b[i, : y.shape[0], : y.shape[1]] = y
            _fill_pad(uv_b[i], uv.shape[0], uv.shape[1], 128)
            uv_b[i, : uv.shape[0], : uv.shape[1]] = uv
        return y_b, uv_b
    if isinstance(imgs[0], (DctImage, tuple)):
        raise ValueError("input_format='rgb' takes an RGB image, not YUV planes or a DctImage")
    if n == 1 and alloc is np.empty and imgs[0].shape[:2] == (bucket_h, bucket_w):
        return imgs[0][None]  # already the canvas: uploaded as it is, no host copy
    batch = alloc((n, bucket_h, bucket_w, imgs[0].shape[2]), imgs[0].dtype)
    for i, im in enumerate(imgs):
        _fill_pad(batch[i], im.shape[0], im.shape[1], 0)
        batch[i, : im.shape[0], : im.shape[1]] = im
    return batch


def _to_device(staged, device: torch.device):
    """A pageable upload of ``_stage_batch_host``'s output: one array, or a
    tuple of planes, to tensors of the same structure on ``device``."""
    if isinstance(staged, tuple):
        return tuple(_to_device(a, device) for a in staged)
    # uint16 deltas travel as their int16 bits (unpack_sparse_ac widens them)
    return torch.from_numpy(staged.view(np.int16) if staged.dtype == np.uint16 else staged).to(device)


# --- plans, constants, fetches -------------------------------------------------


def _plan(h: int, w: int, n, detection_model: DetectionModel, opts: dict) -> dict:
    """Host-side (cheap) plan for one image size: grid, buckets, options."""
    slice_height, slice_width = opts["slice_height"], opts["slice_width"]
    if slice_height is None or slice_width is None:
        if not opts["auto_slice_resolution"]:
            raise ValueError("slice size required when auto_slice_resolution=False")
        s = adaptive_slice_size(h, w)
        slice_height, slice_width = slice_height or s, slice_width or s
    if opts["input_format"] not in INPUT_FORMATS:
        raise ValueError(f"unknown input_format {opts['input_format']!r}; expected one of {INPUT_FORMATS}")
    grid = compute_slice_grid(
        h, w, slice_height, slice_width, opts["overlap_height_ratio"], opts["overlap_width_ratio"]
    )
    t_bucket = bucket_tile_count(grid.num_tiles)
    offsets, tile_valid = pad_grid_offsets(grid, t_bucket)
    return {
        "h": h, "w": w, "n": n, "grid": grid, "t_bucket": t_bucket,
        "offsets": offsets, "tile_valid": tile_valid,
        # the padded canvas is bucketed so a variable-resolution stream
        # takes few distinct shapes
        "bucket_h": bucket_image_dim(grid.padded_h), "bucket_w": bucket_image_dim(grid.padded_w),
        "slice_height": slice_height, "slice_width": slice_width,
        "standard": bool(opts["perform_standard_pred"]),
        "conf": float(detection_model.confidence_threshold),
        "postprocess_type": opts["postprocess_type"],
        "postprocess_match_metric": opts["postprocess_match_metric"],
        "postprocess_match_threshold": opts["postprocess_match_threshold"],
        "postprocess_class_agnostic": opts["postprocess_class_agnostic"],
        "merge_capacity": int(opts["merge_capacity"]),
        "fetch_capacity": int(opts["fetch_capacity"]) if opts["fetch_capacity"] else 0,
        "img_size": int(detection_model.image_size or max(slice_height, slice_width)),
        "input_format": opts["input_format"],
        "canvas_dtype": _canvas_dtype(detection_model),
    }


def _resident_grid_consts(detection_model: DetectionModel, plan: dict, device: torch.device):
    """(offsets, tile_valid, true_hw) on the device, cached on the model by
    value: a stream of same-size images uploads them once."""
    cache = detection_model.__dict__.setdefault("_grid_consts", {})
    key = (plan["offsets"].tobytes(), plan["tile_valid"].tobytes(), plan["h"], plan["w"], str(device))
    entry = cache.get(key)
    if entry is None:
        entry = (
            torch.from_numpy(plan["offsets"]).to(device),
            torch.from_numpy(plan["tile_valid"]).to(device),
            torch.tensor([plan["h"], plan["w"]], dtype=torch.float32, device=device),
        )
        cache[key] = entry
    return entry


class _Fetch:
    """A device result on its way to the host. On a CUDA device the copy
    goes into pinned memory without blocking, behind an event on the stream
    that computed the result; ``result()`` waits on that event alone, in a
    ``fetch_wait`` span of the request that made the fetch (``wait``)."""

    def __init__(self, det: Detections):
        self._request = SPANS.current_request()
        self.wait = None
        self._event = None
        if det.scores.device.type == "cuda":
            self._host = det.map(
                lambda x: torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x, non_blocking=True)
            )
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = det

    def result(self) -> Detections:
        with SPANS.span("fetch_wait", self._request) as self.wait:
            if self._event is not None:
                self._event.synchronize()
        return self._host


class _StagingSlot:
    """Pinned host buffers for one staged batch, reused across batches, and
    the event of their last upload: ``alloc`` may rewrite a buffer only after
    that event has fired."""

    def __init__(self, device: torch.device, copy_stream):
        self.device = device
        self.copy_stream = copy_stream
        self._buffers: list[torch.Tensor] = []
        self._cursor = 0
        self._uploaded = None

    def begin(self) -> None:
        if self._uploaded is not None:
            self._uploaded.synchronize()
        self._cursor = 0

    def alloc(self, shape, dtype) -> np.ndarray:
        """An uninitialised pinned array: a numpy view of the slot's next
        buffer, which grows (by a quarter over the need) when it is short."""
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        k = self._cursor
        self._cursor += 1
        if k == len(self._buffers):
            self._buffers.append(torch.empty(0, dtype=torch.uint8))
        if self._buffers[k].numel() < nbytes:
            self._buffers[k] = torch.empty(nbytes + nbytes // 4, dtype=torch.uint8, pin_memory=True)
        return self._buffers[k][:nbytes].numpy().view(dtype).reshape(shape)

    def upload(self, staged):
        """Staged arrays -> device tensors, copied on the copy stream; the
        calling thread's stream waits for the copy, and the tensors are
        marked as used by it so their memory outlives its work."""
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy_stream):
            out = tuple(
                torch.from_numpy(a).to(self.device, non_blocking=True)
                for a in (staged if isinstance(staged, tuple) else (staged,))
            )
            self._uploaded = torch.cuda.Event()
            self._uploaded.record()
        compute.wait_event(self._uploaded)
        for x in out:
            x.record_stream(compute)
        return out if isinstance(staged, tuple) else out[0]


# --- several devices ---------------------------------------------------------------


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def _replica(detection_model: DetectionModel, device) -> DetectionModel:
    """The detector on ``device``: itself on its own device, else its
    ``replica(device)``, built once and cached on the detector (rebuilt when
    its ``model`` or ``variables`` is replaced), as the JAX engine keeps one
    copy of the variables per device."""
    device = resolve_device(device)
    if _same_device(device, detection_model.device):
        return detection_model
    cache = detection_model.__dict__.setdefault("_replicas", {})
    weights = (detection_model.model, getattr(detection_model, "variables", None))
    entry = cache.get(str(device))
    if entry is None or any(a is not b for a, b in zip(entry[0], weights)):
        rep = detection_model.replica(device)
        for key in ("_replicas", "_grid_consts", "_sharded_forward"):
            rep.__dict__.pop(key, None)
        entry = (weights, rep)
        cache[str(device)] = entry
    return entry[1]


def _mesh_devices(devices) -> list[torch.device]:
    """A device list, or a ``DeviceMesh``: the device of each of its ranks,
    rank r on ``cuda:(r mod the local device count)`` (``cpu`` for a CPU
    mesh), in rank order."""
    if isinstance(devices, DeviceMesh):
        ranks = devices.mesh.flatten().tolist()
        if devices.device_type == "cuda":
            return [torch.device("cuda", r % torch.cuda.device_count()) for r in ranks]
        return [torch.device(devices.device_type)] * len(ranks)
    return [torch.device(d) for d in devices]


def _sharded_forward(detection_model: DetectionModel, mesh):
    """The detector's tile forward split over the mesh's ``tile`` ranks,
    cached on the detector per mesh."""
    from facedet_tpu_torch.parallel.sharding import shard_tile_batch_forward

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh (parallel.create_mesh), not {type(mesh).__name__}")
    if mesh.device_type != detection_model.device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot run a detector on {detection_model.device}")
    entry = detection_model.__dict__.get("_sharded_forward")
    if entry is None or entry[0] is not mesh:
        entry = (mesh, shard_tile_batch_forward(detection_model.tile_forward_nchw, mesh))
        detection_model._sharded_forward = entry
    return entry[1]


# --- single image ----------------------------------------------------------------


def _dispatch_sliced(img, detection_model: DetectionModel, opts: dict):
    """Enqueue the sliced pipeline for one image, run as a batch of one
    (``batch_core``), and start the copy of its row to the host, in spans of
    the request open on this thread: ``plan``, ``stage``
    (``_stage_batch_host``, or the pad on the device of a tensor input),
    ``upload`` and ``_pipeline``'s. Returns (the pending fetch, the plan, the
    ``plan`` span): callers keep several images in flight
    (``predict_stream``) before they wait on a result. With ``opts["mesh"]``
    every rank of the mesh must call it with the same image (SPMD); each
    gets the whole result."""
    mesh = opts.get("mesh")
    forward = None if mesh is None else _sharded_forward(detection_model, mesh)
    h, w = _image_hw(img)
    with SPANS.span("plan") as planned:
        plan = _plan(h, w, 1, detection_model, opts)

    device = detection_model.device
    fmt = plan["input_format"]
    with torch.inference_mode(), _exact_float32(plan["canvas_dtype"] == torch.float32):
        if isinstance(img, torch.Tensor):
            if fmt != "rgb":
                raise ValueError("a tensor input is an RGB image: input_format must be 'rgb'")
            with SPANS.span("stage"):
                # already on a device: pad there, no trip through the host
                dev = torch.nn.functional.pad(
                    img.to(device), (0, 0, 0, plan["bucket_w"] - w, 0, plan["bucket_h"] - h)
                )[None]
        else:
            with SPANS.span("stage"):
                staged = _stage_batch_host([img], fmt, plan["bucket_h"], plan["bucket_w"])
            with SPANS.span("upload"):
                dev = _to_device(staged, device)
        consts = _resident_grid_consts(detection_model, plan, device)
        fetch = _Fetch(batch_core(detection_model, plan, dev, consts, forward).map(lambda x: x[0]))
    return fetch, plan, planned


def _durations(planned, fetch: _Fetch) -> dict[str, float]:
    """A request's ``durations_in_seconds`` from its spans: ``slice`` is the
    ``plan`` span, ``prediction`` runs from the plan's end to the result on
    the host (the end of the fetch's ``fetch_wait``)."""
    return {"slice": planned.seconds, "prediction": (fetch.wait.end_ns - planned.end_ns) / 1e9}


def get_prediction(
    image,
    detection_model: DetectionModel,
    shift_amount: tuple[int, int] = (0, 0),
    full_shape: Optional[tuple[int, int]] = None,
    postprocess=None,
    verbose: int = 0,
) -> PredictionResult:
    """Single-image (or single-slice) inference. A tensor input stays on
    its device (it is letterboxed there) and is fetched only for
    ``PredictionResult.image``."""
    img = _prepare_image(image)
    if isinstance(img, (DctImage, tuple)):
        raise ValueError("get_prediction takes an RGB image; the other formats need the sliced path")
    with SPANS.span("request"):
        # the result reaches the host inside the conversion
        with SPANS.span("predict") as predicted:
            detection_model.perform_inference(img)
            detection_model.convert_original_predictions(
                shift_amount=shift_amount,
                full_shape=full_shape if full_shape is not None else tuple(img.shape[:2]),
            )
        return PredictionResult(
            image=_display_image(img),
            object_prediction_list=detection_model.object_prediction_list,
            durations_in_seconds={"prediction": predicted.seconds},
        )


def get_sliced_prediction(
    image,
    detection_model: DetectionModel,
    slice_height: Optional[int] = None,
    slice_width: Optional[int] = None,
    overlap_height_ratio: float = 0.2,
    overlap_width_ratio: float = 0.2,
    perform_standard_pred: bool = True,
    postprocess_type: str = "GREEDYNMM",
    postprocess_match_metric: str = "IOS",
    postprocess_match_threshold: float = 0.5,
    postprocess_class_agnostic: bool = False,
    auto_slice_resolution: bool = True,
    merge_capacity: int = 1024,
    merge_buffer_length: Optional[int] = None,
    input_format: str = "rgb",
    mesh=None,
    fetch_capacity: Optional[int] = None,
    verbose: int = 0,
    return_image: bool = True,
) -> PredictionResult:
    """Sliced inference with global merge, signature-compatible with the
    JAX package's ``get_sliced_prediction``. ``merge_capacity`` bounds the
    detection count entering the merge; ``merge_buffer_length`` folds into
    it. ``image`` is an RGB image (numpy, PIL, or a torch tensor HWC, uint8
    or float in [0, 1], which is padded on its device), ``(Y, UV)`` planes
    with ``input_format="yuv420"``, or a ``DctImage`` with ``"dct420"`` /
    ``"dct420s"`` (an RGB image is encoded on the fly). ``return_image=False``
    skips the display image (``PredictionResult.image`` is None).

    ``mesh``: a ``DeviceMesh`` (parallel/mesh.create_mesh) whose ranks all
    call this with the same image and options; the tile batch splits over
    its ``tile`` axis, and every rank returns the same result.

    The call is a ``request`` span (a child of the request open on this
    thread, as in ``enhance_first_pipeline``, else a new request's first
    span); ``durations_in_seconds`` comes from its spans (``_durations``)."""
    with SPANS.span("request"):
        if merge_buffer_length is not None:
            merge_capacity = min(merge_capacity, max(int(merge_buffer_length), 64))
        img = _prepare_image(image)
        opts = _stream_opts(dict(
            slice_height=slice_height, slice_width=slice_width,
            overlap_height_ratio=overlap_height_ratio, overlap_width_ratio=overlap_width_ratio,
            perform_standard_pred=perform_standard_pred, postprocess_type=postprocess_type,
            postprocess_match_metric=postprocess_match_metric,
            postprocess_match_threshold=postprocess_match_threshold,
            postprocess_class_agnostic=postprocess_class_agnostic,
            auto_slice_resolution=auto_slice_resolution, merge_capacity=merge_capacity,
            input_format=input_format, fetch_capacity=fetch_capacity,
        ))
        opts["mesh"] = mesh
        fetch, plan, planned = _dispatch_sliced(img, detection_model, opts)
        merged = fetch.result()
        durations = _durations(planned, fetch)
        durations["postprocess"] = 0.0  # merged on the device inside the pipeline

        preds = detections_to_object_predictions(
            merged, detection_model.category_mapping, full_shape=(plan["h"], plan["w"])
        )
        if verbose:
            print(
                f"Performing prediction on {plan['grid'].num_tiles} slices "
                f"(bucket {plan['t_bucket']}, {plan['slice_height']}x{plan['slice_width']}): "
                + ", ".join(f"{k}={v:.3f}s" for k, v in durations.items())
            )
        return PredictionResult(
            image=_display_image(img) if return_image else None,
            object_prediction_list=preds,
            durations_in_seconds=durations,
            detections=merged,
        )


def predict_stream(
    images,
    detection_model: DetectionModel,
    window: int = 3,
    raw: bool = False,
    **sliced_kwargs,
):
    """Pipelined sliced prediction over an image stream.

    Keeps up to ``window`` images in flight: the next images' staging,
    uploads and device work overlap the current image's copy to the host.
    Yields a ``PredictionResult`` per image, in input order (or the merged
    ``Detections`` on the host when ``raw=True``). Each image is a
    ``request`` span over its dispatch, and its ``fetch_wait`` joins that
    request when its turn comes.
    """
    opts = _stream_opts(sliced_kwargs)

    def dispatch(img):
        with SPANS.span("request"):
            return _dispatch_sliced(img, detection_model, opts)

    def finalize(img, fetch, plan, planned):
        merged = fetch.result()
        if raw:
            return merged
        preds = detections_to_object_predictions(
            merged, detection_model.category_mapping, full_shape=(plan["h"], plan["w"])
        )
        return PredictionResult(
            image=_display_image(img),
            object_prediction_list=preds,
            durations_in_seconds=_durations(planned, fetch),
            detections=merged,
        )

    inflight: deque = deque()
    for image in images:
        img = _prepare_image(image)
        inflight.append((img, *dispatch(img)))
        if len(inflight) >= window:
            yield finalize(*inflight.popleft())
    while inflight:
        yield finalize(*inflight.popleft())


# --- batches -----------------------------------------------------------------------


def _plan_sliced_batch(imgs: list, detection_model: DetectionModel, opts: dict) -> dict:
    """Host-side (cheap) batch plan: grid, buckets, options. There is no
    mesh here: ``_stream_opts`` drops it, as the JAX engine's does, so the
    batch paths run on the detector's own device."""
    h, w = _image_hw(imgs[0])
    if any(_image_hw(im) != (h, w) for im in imgs):
        raise ValueError("batched sliced prediction requires same-size images")
    if any(isinstance(im, torch.Tensor) for im in imgs):
        raise ValueError("batched sliced prediction stages host images; pass numpy arrays, planes or DctImages")
    return _plan(h, w, len(imgs), detection_model, opts)


def _dispatch_staged_batch(plan: dict, staged, detection_model: DetectionModel,
                           slot: Optional[_StagingSlot] = None, request: Optional[int] = None) -> _Fetch:
    """Upload a host-staged batch, enqueue the batch pipeline and start the
    copy of its result (batch axis leading) to the host, in the spans
    ``upload`` and ``enqueue`` of ``request`` (default: the request open on
    this thread). With a staging ``slot`` the upload runs on the slot's copy
    stream from pinned memory."""
    device = detection_model.device
    with torch.inference_mode(), _exact_float32(plan["canvas_dtype"] == torch.float32), _on_device(device):
        with SPANS.span("upload", request):
            batch_dev = _to_device(staged, device) if slot is None else slot.upload(staged)
        with SPANS.span("enqueue", request):
            consts = _resident_grid_consts(detection_model, plan, device)
            return _Fetch(batch_core(detection_model, plan, batch_dev, consts))


def _dispatch_sliced_batch(imgs: list, detection_model: DetectionModel, opts: dict) -> _Fetch:
    """Plan + stage + upload + dispatch in one call (the non-streamed batch
    path). The streamed path runs the phases on separate threads: see
    ``predict_stream_batched``."""
    with SPANS.span("plan"):
        plan = _plan_sliced_batch(imgs, detection_model, opts)
    with SPANS.span("stage"):
        staged = _stage_batch_host(imgs, plan["input_format"], plan["bucket_h"], plan["bucket_w"])
    return _dispatch_staged_batch(plan, staged, detection_model)


def _batch_results(imgs: list, merged: Detections, detection_model: DetectionModel) -> list[PredictionResult]:
    h, w = _image_hw(imgs[0])
    results = []
    for i, im in enumerate(imgs):
        det = merged.map(lambda x: x[i])
        preds = detections_to_object_predictions(det, detection_model.category_mapping, full_shape=(h, w))
        results.append(PredictionResult(image=_display_image(im), object_prediction_list=preds, detections=det))
    return results


def get_sliced_prediction_batch(
    images,
    detection_model: DetectionModel,
    raw: bool = False,
    **sliced_kwargs,
):
    """Batched sliced prediction over SAME-SIZE images: one upload, one tile
    gather launch per chunk, the detector over flattened tile batches, so the
    per-launch host cost is shared by the batch. Returns a list of
    ``PredictionResult`` (or the batched ``Detections`` on the host when
    ``raw=True``)."""
    imgs = [_prepare_image(im) for im in images]
    if not imgs:
        return []
    with SPANS.span("request"):
        merged = _dispatch_sliced_batch(imgs, detection_model, _stream_opts(sliced_kwargs)).result()
        return merged if raw else _batch_results(imgs, merged, detection_model)


def predict_stream_batched(
    images,
    detection_model: DetectionModel,
    batch_size: int = 8,
    window: int = 3,
    raw: bool = False,
    devices=None,
    **sliced_kwargs,
):
    """Windowed, pipelined batched sliced prediction over an image stream
    (default ``window=3`` batches in flight): the serving configuration.

    Consecutive same-size images are grouped into batches of ``batch_size``
    (a size change flushes the batch); up to ``window`` batches stay in
    flight. Two single-thread workers keep order: one stages a batch into
    pinned host memory, the other uploads it on a copy stream and enqueues
    the device work. The merge reads a flag back from the device once per
    round, which blocks the thread that enqueues, so that thread is not the
    one that waits for results: the caller's thread only waits on the event
    of a batch's copy to the host. Yields per batch, in input order, a list
    of ``PredictionResult`` (or the batched ``Detections`` on the host when
    ``raw=True``). An exception in a worker is raised here, when its batch's
    turn comes.

    Each batch is one request of ``SPANS``, its id passed to the workers:
    ``stage`` on the stage worker, ``upload`` and ``enqueue`` (with
    ``_pipeline``'s spans under it) on the dispatch worker, ``fetch_wait``
    on the caller's thread. Which of the three threads holds the stream back
    shows in their spans.

    ``devices`` turns on serving over several devices: a list of devices
    (``torch.device`` or names), or a ``DeviceMesh``, which stands for the
    device of each of its ranks (rank r on ``cuda:(r mod the local device
    count)``, ``cpu`` for a CPU mesh). Consecutive batches round-robin over
    them from this one process, with no collective: each device runs whole
    batches on its own replica of the detector (built once and cached), and
    the window widens to ``len(devices) + 1`` so that none sits idle. A
    device may appear more than once. Results stay in submission order.
    """
    opts = _stream_opts(sliced_kwargs)
    targets = [detection_model]
    if devices is not None:
        devices = _mesh_devices(devices)
        if devices:
            targets = [_replica(detection_model, d) for d in devices]
            window = max(window, len(devices) + 1)
    # per device: a copy stream, and a ring of staging slots; a slot is
    # reused once `window` later batches were flushed, by when its batch has
    # been consumed; the slot still waits on its own upload event
    rings = {}
    for m in targets:
        if m.device.type == "cuda" and str(m.device) not in rings:
            stream = torch.cuda.Stream(m.device)
            rings[str(m.device)] = itertools.cycle([_StagingSlot(m.device, stream) for _ in range(max(window, 1) + 1)])

    def finalize(imgs, fut):
        merged = fut.result().result()
        return merged if raw else _batch_results(imgs, merged, detection_model)

    def stage(pending, plan, slot, request):
        with SPANS.span("stage", request):
            if slot is None:
                return _stage_batch_host(pending, plan["input_format"], plan["bucket_h"], plan["bucket_w"])
            slot.begin()
            return _stage_batch_host(pending, plan["input_format"], plan["bucket_h"], plan["bucket_w"],
                                     alloc=slot.alloc)

    inflight: deque = deque()
    pending: list = []
    stage_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="facedet-stage")
    dispatch_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="facedet-dispatch")
    n_flushed = 0

    def flush(pending):
        nonlocal n_flushed
        target = targets[n_flushed % len(targets)]
        n_flushed += 1
        plan = _plan_sliced_batch(pending, target, opts)
        ring = rings.get(str(target.device))
        slot = next(ring) if ring else None
        request = SPANS.new_request()
        staged_fut = stage_pool.submit(stage, pending, plan, slot, request)
        fut = dispatch_pool.submit(
            lambda: _dispatch_staged_batch(plan, staged_fut.result(), target, slot=slot, request=request)
        )
        inflight.append((pending, fut))

    try:
        for image in images:
            img = _prepare_image(image)
            if pending and (_image_hw(img) != _image_hw(pending[0]) or len(pending) >= batch_size):
                flush(pending)
                pending = []
                if len(inflight) >= window:
                    yield finalize(*inflight.popleft())
            pending.append(img)
        if pending:
            flush(pending)
        while inflight:
            yield finalize(*inflight.popleft())
    finally:
        stage_pool.shutdown(wait=True, cancel_futures=True)
        dispatch_pool.shutdown(wait=True, cancel_futures=True)


def _stream_opts(sliced_kwargs: dict) -> dict:
    known = {
        "slice_height": None, "slice_width": None,
        "overlap_height_ratio": 0.2, "overlap_width_ratio": 0.2,
        "perform_standard_pred": True,
        "postprocess_type": "GREEDYNMM", "postprocess_match_metric": "IOS",
        "postprocess_match_threshold": 0.5, "postprocess_class_agnostic": False,
        "auto_slice_resolution": True, "merge_capacity": 1024,
        "input_format": "rgb", "fetch_capacity": None, "mesh": None,
    }
    unknown = set(sliced_kwargs) - set(known)
    if unknown:
        raise TypeError(f"unknown sliced-prediction options: {sorted(unknown)}")
    opts = {k: sliced_kwargs.get(k, default) for k, default in known.items()}
    # `mesh` is accepted and dropped, as the JAX engine's `_stream_opts`
    # drops it: the streams and the batch paths run unsharded
    opts["mesh"] = None
    return opts


def _on_device(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device (the dispatching
    thread's kernels and streams then default to it), else nothing."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
