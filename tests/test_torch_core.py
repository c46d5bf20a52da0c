"""The port's core and host functions against the JAX package on the CPU:
package isolation, device resolution, the tile grid and its bucketing, box
geometry, ``Detections`` ordering, and the ``jax.image`` resampler."""
import dataclasses
import itertools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.core import boxes as jboxes
from facedet_tpu.core import letterbox as jletterbox
from facedet_tpu.core.detections import Detections as JDetections
from facedet_tpu.ops import tiler as jtiler
from facedet_tpu_torch.core import boxes, letterbox
from facedet_tpu_torch.core.detections import Detections, concat_detections
from facedet_tpu_torch.ops import image as timage
from facedet_tpu_torch.ops import tiler

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of facedet_tpu_torch imported in a fresh interpreter
    leaves jax, flax and facedet_tpu out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import facedet_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'facedet_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'facedet_tpu'))\n"
        "assert len(mods) > 15, mods\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YoloV11PoseDetectionModel(scale="n", load_at_init=False)
    assert resolve_device("cpu") == torch.device("cpu")


GRID_CASES = [
    (1024, 1536, 640, 640, 0.2, 0.2),
    (512, 768, 320, 320, 0.2, 0.2),
    (100, 80, 128, 128, 0.2, 0.2),
    (2000, 3000, 512, 416, 0.3, 0.25),
    (640, 640, 640, 640, 0.2, 0.2),
    (641, 1281, 640, 640, 0.0, 0.5),
    (4000, 6000, 512, 512, 0.3, 0.3),
    (1, 1, 64, 64, 0.2, 0.2),
]


@pytest.mark.parametrize("case", GRID_CASES, ids=lambda c: "x".join(map(str, c)))
def test_slice_grid_matches_jax(case):
    want = jtiler.compute_slice_grid(*case)
    got = tiler.compute_slice_grid(*case)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.offsets.dtype == np.int32
    for f in ("slice_h", "slice_w", "image_h", "image_w", "padded_h", "padded_w", "num_tiles"):
        assert getattr(got, f) == getattr(want, f), f
    bucket = tiler.bucket_tile_count(got.num_tiles)
    assert bucket == jtiler.bucket_tile_count(want.num_tiles)
    for a, b in zip(tiler.pad_grid_offsets(got, bucket), jtiler.pad_grid_offsets(want, bucket)):
        np.testing.assert_array_equal(a, b)
    assert tiler.bucket_image_dim(got.padded_h) == jtiler.bucket_image_dim(want.padded_h)
    assert tiler.bucket_image_dim(got.padded_w, 128) == jtiler.bucket_image_dim(want.padded_w, 128)


def test_slice_policies_and_buckets_match_jax():
    dims = [1, 63, 320, 500, 767, 768, 1000, 1501, 2501, 2999, 3000, 4500]
    for h, w in itertools.product(dims, dims):
        assert tiler.adaptive_slice_size(h, w) == jtiler.adaptive_slice_size(h, w)
        assert tiler.half_image_slice_size(h, w) == jtiler.half_image_slice_size(h, w)
        assert tiler.fixed_grid_slice_params(h, w) == jtiler.fixed_grid_slice_params(h, w)
    for n in range(1, 300):
        assert tiler.bucket_tile_count(n) == jtiler.bucket_tile_count(n)
    with pytest.raises(ValueError):
        tiler.pad_grid_offsets(tiler.compute_slice_grid(1024, 1536, 640, 640), 4)


def _boxes(rng, n):
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(-5, 40, (n, 2))  # some negative extents: degenerate boxes
    b = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    b[:3] = b[3:6]  # exact duplicates
    return b


@pytest.mark.parametrize("seed", [0, 1])
def test_box_geometry_matches_jax(seed):
    """IoU/IOS/area/clip, same eps. Tolerance 1e-6: the same float32
    formulas, evaluated by two libraries."""
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, 17), _boxes(rng, 11)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(boxes.box_area(ta).numpy(), np.asarray(jboxes.box_area(a)), atol=1e-6)
    for metric in ("IOU", "IOS", "iou"):
        np.testing.assert_allclose(
            boxes.pair_metric_matrix(ta, tb, metric).numpy(),
            np.asarray(jboxes.pair_metric_matrix(jnp.asarray(a), jnp.asarray(b), metric)),
            atol=1e-6,
        )
    with pytest.raises(ValueError):
        boxes.pair_metric_matrix(ta, tb, "GIOU")
    np.testing.assert_array_equal(
        boxes.clip_boxes(ta, 60.0, 80.0).numpy(), np.asarray(jboxes.clip_boxes(jnp.asarray(a), 60.0, 80.0))
    )


def _det_arrays(rng, n, k=5):
    scores = rng.choice(np.float32([0.1, 0.5, 0.5, 0.9, 0.3]), n)  # many ties
    return {
        "boxes": _boxes(rng, n),
        "scores": scores,
        "classes": rng.integers(0, 3, n).astype(np.int32),
        "kpts": rng.normal(size=(n, k, 3)).astype(np.float32),
        "valid": rng.random(n) > 0.3,
    }


def test_sort_by_score_is_stable_under_ties():
    """Tied scores keep their row order, as ``jnp.argsort`` (stable) keeps
    it: exact equality."""
    arrs = _det_arrays(np.random.default_rng(3), 40)
    want = JDetections(**{k: jnp.asarray(v) for k, v in arrs.items()}).sort_by_score()
    got = Detections(**{k: torch.from_numpy(v) for k, v in arrs.items()}).sort_by_score()
    for f in ("boxes", "scores", "classes", "kpts", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    jn, tn = want.to_numpy(), got.to_numpy()
    for f in jn:
        np.testing.assert_array_equal(tn[f], jn[f])


def test_concat_detections_truncates_by_score():
    from facedet_tpu.core.detections import concat_detections as jconcat

    rng = np.random.default_rng(4)
    parts = [_det_arrays(rng, 12), _det_arrays(rng, 9)]
    want = jconcat([JDetections(**{k: jnp.asarray(v) for k, v in p.items()}) for p in parts], 15)
    got = concat_detections([Detections(**{k: torch.from_numpy(v) for k, v in p.items()}) for p in parts], 15)
    assert got.capacity == 15
    for f in ("boxes", "scores", "classes", "kpts", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("capacity", [21, 15, 64])
def test_tail_concat_sorts_ties_in_jax_row_order(capacity):
    """The pipeline's tail (facedet_tpu/engine/predict.py:282-295) joins the
    tile part and the full-image part and always sorts by score, also when
    the capacity already fits. Scores tied across the two parts keep JAX's
    row order (tile rows first): exact equality, with and without a leading
    batch axis."""
    from facedet_tpu.engine.predict import _truncate_by_score as jtruncate

    rng = np.random.default_rng(6)
    batches = []
    for _ in range(2):
        parts = [_det_arrays(rng, 12), _det_arrays(rng, 9)]
        joined = JDetections(**{k: jnp.concatenate([jnp.asarray(p[k]) for p in parts], axis=0) for k in parts[0]})
        want = jtruncate(joined, capacity)
        tparts = [Detections(**{k: torch.from_numpy(v) for k, v in p.items()}) for p in parts]
        got = concat_detections(tparts, capacity)
        assert got.capacity == min(capacity, 21)
        for f in ("boxes", "scores", "classes", "kpts", "valid"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
        batches.append((tparts, got))
    # the same two images as one batch: [2, N, ...] parts
    stacked = [
        Detections(*(torch.stack([getattr(b[0][i], f) for b in batches]) for f in ("boxes", "scores", "classes", "kpts", "valid")))
        for i in range(2)
    ]
    got = concat_detections(stacked, capacity)
    assert got.boxes.shape == (2, min(capacity, 21), 4) and got.kpts.shape == (2, min(capacity, 21), 5, 3)
    for i, (_, single) in enumerate(batches):
        for f in ("boxes", "scores", "classes", "kpts", "valid"):
            np.testing.assert_array_equal(getattr(got, f)[i].numpy(), getattr(single, f).numpy(), err_msg=f)


@pytest.mark.parametrize(
    "in_hw,out_hw,scale",
    [
        ((1024, 1536), (640, 640), 640 / 1536),  # the standard pass: downscale
        ((256, 512), (320, 320), 320 / 500),  # true size inside a padded canvas
        ((48, 40), (160, 160), 160 / 48),  # upscale
        ((37, 53), (64, 64), 1.0),
    ],
)
def test_scale_and_translate_matches_jax(in_hw, out_hw, scale):
    """``jax.image.scale_and_translate(method="linear")``: antialiased
    triangle weights, top-left aligned, zero outside. atol 1e-5: float32
    sums over at most a few thousand weights, in another order."""
    img = np.random.default_rng(5).uniform(0, 1, in_hw + (3,)).astype(np.float32)
    s = jnp.float32(scale)
    want = jax.image.scale_and_translate(
        jnp.asarray(img), out_hw + (3,), (0, 1), jnp.stack([s, s]), jnp.zeros(2), method="linear"
    )
    got = timage.scale_and_translate_chw(torch.from_numpy(img).permute(2, 0, 1), *out_hw, torch.tensor(scale))
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("src_hw,dst", [((512, 768), 320), ((300, 200), 640), ((640, 640), 640)])
def test_letterbox_matches_jax(src_hw, dst):
    """``apply_letterbox`` (``jax.image.resize`` bilinear, antialiased, grey
    pad) and the inverse box/keypoint maps. atol 1e-5 as above."""
    img = np.random.default_rng(6).uniform(0, 1, src_hw + (3,)).astype(np.float32)
    spec = letterbox.compute_letterbox(*src_hw, dst)
    assert dataclasses.astuple(spec) == dataclasses.astuple(jletterbox.compute_letterbox(*src_hw, dst))
    want = jletterbox.apply_letterbox(jnp.asarray(img), spec)
    got = letterbox.apply_letterbox(torch.from_numpy(img), spec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    b = np.float32([[10, 20, 110, 220], [0, 0, 5, 5]])
    np.testing.assert_allclose(
        letterbox.unletterbox_boxes(torch.from_numpy(b), spec).numpy(),
        np.asarray(jletterbox.unletterbox_boxes(jnp.asarray(b), spec)), rtol=1e-6,
    )
    k = np.random.default_rng(7).uniform(0, dst, (2, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        letterbox.unletterbox_kpts(torch.from_numpy(k), spec).numpy(),
        np.asarray(jletterbox.unletterbox_kpts(jnp.asarray(k), spec)), rtol=1e-6,
    )
