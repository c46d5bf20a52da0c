"""The port's greedy merge (facedet_tpu_torch/ops/nms.py) against the JAX
package's ``merge_detections`` on the CPU, over every mode, both match
metrics, class-agnostic or not, on random boxes with tied scores, exact
duplicates and invalid rows.

Tolerance: the keep mask, row order, scores, classes and keypoints are
equal; merged boxes agree within 1e-5 (min/max of the same float32 values,
so in practice exactly).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.core.detections import Detections as JDetections
from facedet_tpu.ops.nms import merge_detections as jax_merge
from facedet_tpu_torch.core.detections import Detections
from facedet_tpu_torch.ops.nms import POSTPROCESS_TYPES, merge_detections, nms


def _random_dets(seed: int, n: int = 48, batch: tuple = ()):
    """Boxes in a few tight clusters (so rows match), scores from a small set
    (so they tie), some exact duplicates and ~20% invalid rows."""
    rng = np.random.default_rng(seed)
    shape = batch + (n,)
    centres = rng.uniform(20, 180, (6, 2))
    c = centres[rng.integers(0, 6, shape)] + rng.normal(0, 4, shape + (2,))
    wh = rng.uniform(8, 30, shape + (2,))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    boxes[..., 5:8, :] = boxes[..., 0:3, :]
    return {
        "boxes": boxes,
        "scores": rng.choice(np.float32([0.3, 0.45, 0.6, 0.6, 0.8, 0.95]), shape),
        "classes": rng.integers(0, 2, shape).astype(np.int32),
        "kpts": rng.normal(size=shape + (5, 3)).astype(np.float32),
        "valid": rng.random(shape) > 0.2,
    }


def _assert_same(got: Detections, want):
    for f in ("valid", "scores", "classes", "kpts"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-5)


CASES = list(itertools.product(POSTPROCESS_TYPES, ("IOU", "IOS"), (True, False)))


@pytest.mark.parametrize("mode,metric,agnostic", CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_matches_jax(mode, metric, agnostic, seed):
    arrs = _random_dets(seed)
    kw = dict(mode=mode, match_metric=metric, match_threshold=0.5, class_agnostic=agnostic)
    want = jax_merge(JDetections(**{k: jnp.asarray(v) for k, v in arrs.items()}), **kw)
    got = merge_detections(Detections(**{k: torch.from_numpy(v) for k, v in arrs.items()}), **kw)
    _assert_same(got, want)
    assert 0 < int(got.valid.sum()) < int(arrs["valid"].sum())  # the case merges something


def test_batched_merge_matches_vmapped_jax():
    """The per-tile NMS of the decode runs the merge over a [T, k] batch, as
    the JAX decode vmaps it."""
    arrs = _random_dets(2, n=40, batch=(3,))
    want = jax.vmap(lambda d: jax_merge(d, mode="NMS", match_metric="IOU", match_threshold=0.7))(
        JDetections(**{k: jnp.asarray(v) for k, v in arrs.items()})
    )
    got = nms(Detections(**{k: torch.from_numpy(v) for k, v in arrs.items()}), iou_threshold=0.7)
    _assert_same(got, want)


def test_unknown_mode_and_empty_input():
    det = Detections.empty(8)
    with pytest.raises(ValueError):
        merge_detections(det, mode="SOFTNMS")
    out = merge_detections(det)
    assert not bool(out.valid.any())
