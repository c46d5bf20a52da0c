"""Fixed-capacity detection tensors — the port's data model.

Counterpart of facedet_tpu/core/detections.py: the same five fields with the
same shapes and dtypes, as torch tensors on one device. A leading batch axis
(``[B, N, ...]``) is allowed on every field; ``sort_by_score`` and ``take``
work along the last detection axis.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUM_FACE_KEYPOINTS = 5  # left_eye, right_eye, nose, left_mouth, right_mouth

_FIELDS = ("boxes", "scores", "classes", "kpts", "valid")
# the detection axis of each field, counted from the end
_DET_AXIS = {"boxes": -2, "scores": -1, "classes": -1, "kpts": -3, "valid": -1}


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, ...]`` along axis ``idx.dim() - 1``, batched over the
    leading axes of ``idx`` (``jnp.take_along_axis`` with trailing broadcast)."""
    d = idx.dim() - 1
    trail = x.shape[d + 1 :]
    index = idx.reshape(idx.shape + (1,) * len(trail)).expand(idx.shape + trail)
    return torch.gather(x, d, index)


@dataclasses.dataclass
class Detections:
    """A fixed-capacity batch of detections.

    boxes:   [N, 4] float32, xyxy, global coordinates unless noted
    scores:  [N]    float32
    classes: [N]    int32
    kpts:    [N, K, 3] float32 (x, y, visibility/conf)
    valid:   [N]    bool — rows beyond the live count are padding
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    kpts: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.scores.shape[-1]

    @property
    def num_keypoints(self) -> int:
        return self.kpts.shape[-2]

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(-1)

    def map(self, fn) -> "Detections":
        """Apply ``fn`` to every field (``jax.tree.map`` over the struct)."""
        return Detections(*(fn(getattr(self, f)) for f in _FIELDS))

    @staticmethod
    def cat_batches(parts: list["Detections"]) -> "Detections":
        """Join batched detections along their leading (image) axis."""
        return Detections(*(torch.cat([getattr(p, f) for p in parts], dim=0) for f in _FIELDS))

    @staticmethod
    def empty(capacity: int, num_keypoints: int = NUM_FACE_KEYPOINTS, device=None) -> "Detections":
        return Detections(
            boxes=torch.zeros((capacity, 4), dtype=torch.float32, device=device),
            scores=torch.zeros((capacity,), dtype=torch.float32, device=device),
            classes=torch.zeros((capacity,), dtype=torch.int32, device=device),
            kpts=torch.zeros((capacity, num_keypoints, 3), dtype=torch.float32, device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    def sort_by_score(self) -> "Detections":
        """Descending score order; invalid rows sink to the end. The sort is
        stable (as ``jnp.argsort``), so tied scores keep their row order."""
        key = torch.where(self.valid, self.scores, torch.full_like(self.scores, -torch.inf))
        order = torch.argsort(-key, dim=-1, stable=True)
        return self.take(order)

    def take(self, idx: torch.Tensor) -> "Detections":
        return self.map(lambda x: take_rows(x, idx))

    def truncate(self, capacity: int) -> "Detections":
        """The first ``capacity`` rows along the detection axis."""
        return Detections(
            *(getattr(self, f).narrow(_DET_AXIS[f], 0, min(capacity, self.capacity)) for f in _FIELDS)
        )

    def mask(self, keep: torch.Tensor) -> "Detections":
        """AND the validity mask with ``keep``."""
        return dataclasses.replace(self, valid=self.valid & keep)

    def filter_score(self, threshold: float) -> "Detections":
        return self.mask(self.scores >= threshold)

    def to(self, device) -> "Detections":
        return self.map(lambda x: x.to(device))

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Host-side edge: drop padding, return compact numpy arrays
        sorted by descending score."""
        valid = self.valid.cpu().numpy()
        out = {f: getattr(self, f).cpu().numpy()[valid] for f in _FIELDS[:4]}
        order = np.argsort(-out["scores"], kind="stable")
        return {k: v[order] for k, v in out.items()}


def concat_detections(parts: list[Detections], capacity: int) -> Detections:
    """Concatenate along the detection axis (leading batch axes allowed),
    then sort by score and cut to ``capacity``. The sort always runs, as the
    JAX pipeline's ``_truncate_by_score`` does: it is stable, so tied scores
    keep the order of ``parts`` and of the rows inside each part."""
    det = Detections(*(torch.cat([getattr(p, f) for p in parts], dim=_DET_AXIS[f]) for f in _FIELDS))
    return det.sort_by_score().truncate(capacity)
