"""Pred x GT IoU matrix: native C++ through ctypes, with a numpy version.

Counterpart of facedet_tpu/eval/bbox_overlaps.py. It replaces the Cython
``bbox_overlaps`` the reference builds from the external WiderFace-Evaluation
repo (eval/eval_official_widerface.py:20-33). The source is shared,
``native/bbox_overlaps.cpp``; this package builds it with
``utils/native.load_native`` into ``build/native/`` at first use, apart from
the JAX package's library beside the source. Semantics (the +1
inclusive-pixel convention) match the official WIDERFACE evaluation script.
"""
from __future__ import annotations

import ctypes

import numpy as np

from facedet_tpu_torch.utils.native import load_native

__all__ = ["bbox_overlaps", "bbox_overlaps_numpy", "native_library"]

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


def native_library():
    """The built ``bbox_overlaps`` library with its signature set, or None
    where it cannot be built (no ``g++``): ``bbox_overlaps`` then takes the
    numpy version."""
    lib = load_native("bbox_overlaps", flags=("-O3", "-march=native"))
    if lib is not None and lib.bbox_overlaps.argtypes is None:
        lib.bbox_overlaps.argtypes = [_DOUBLE_P, ctypes.c_long, _DOUBLE_P, ctypes.c_long, _DOUBLE_P]
        lib.bbox_overlaps.restype = None
    return lib


def bbox_overlaps_numpy(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Vectorized version with identical (+1 inclusive) semantics."""
    boxes = np.asarray(boxes, np.float64)
    query = np.asarray(query, np.float64)
    iw = (
        np.minimum(boxes[:, None, 2], query[None, :, 2])
        - np.maximum(boxes[:, None, 0], query[None, :, 0])
        + 1.0
    )
    ih = (
        np.minimum(boxes[:, None, 3], query[None, :, 3])
        - np.maximum(boxes[:, None, 1], query[None, :, 1])
        + 1.0
    )
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    inter[(iw <= 0) | (ih <= 0)] = 0.0
    b_area = (boxes[:, 2] - boxes[:, 0] + 1.0) * (boxes[:, 3] - boxes[:, 1] + 1.0)
    q_area = (query[:, 2] - query[:, 0] + 1.0) * (query[:, 3] - query[:, 1] + 1.0)
    union = b_area[:, None] + q_area[None, :] - inter
    return inter / union


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """IoU matrix [n, k] between boxes [n, 4] and query [k, 4] (xyxy)."""
    boxes = np.ascontiguousarray(boxes, np.float64)
    query = np.ascontiguousarray(query, np.float64)
    n, k = boxes.shape[0], query.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float64)
    lib = native_library()
    if lib is None:
        return bbox_overlaps_numpy(boxes, query)
    out = np.empty((n, k), np.float64)
    lib.bbox_overlaps(boxes.ctypes.data_as(_DOUBLE_P), n, query.ctypes.data_as(_DOUBLE_P), k,
                      out.ctypes.data_as(_DOUBLE_P))
    return out
