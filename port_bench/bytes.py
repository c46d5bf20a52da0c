"""Bytes that a kernel must move, from shapes, for the per-layer
``*_roofline`` metrics: each input byte read once and each output byte
written once, whatever the kernel reads again.
"""
from __future__ import annotations

import numpy as np


def gather_bytes(canvas_hw, offsets, sh: int, sw: int, channels: int, itemsize: int) -> float:
    """The tile gather of one image: the union of its windows on the
    canvas read once, the ``len(offsets)`` tiles of ``sh`` x ``sw`` written
    once, ``channels`` planes of ``itemsize`` bytes."""
    covered = np.zeros(canvas_hw, bool)
    for y, x in np.asarray(offsets):
        covered[y:y + sh, x:x + sw] = True
    return float((int(covered.sum()) + len(offsets) * sh * sw) * channels * itemsize)
