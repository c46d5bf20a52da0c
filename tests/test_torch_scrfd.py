"""The port's SCRFD (models/scrfd.py, engine/scrfd_wrapper.py) against the
flax model on the CPU in float32: ``scrfd_500m`` with seeded weights carried
across at 72x104 (odd feature maps, so the top-down crop runs) and the
committed golden ``scrfd_2.5g`` at 64x64.

Tolerances: raw per-level maps within 1e-4 (convs sum in another order);
``decode_scrfd`` / ``decode_scrfd_flat`` on seeded maps within 1e-5 px;
``tile_forward`` detections with equal keep masks, boxes within 0.05 px,
scores within 1e-3, keypoints within 0.1 px.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.engine.scrfd_wrapper import ScrfdDetectionModel as JaxScrfdModel
from facedet_tpu.models import scrfd as jax_scrfd
from facedet_tpu_torch.engine.scrfd_wrapper import Face, FaceAnalysis, ScrfdDetectionModel
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models import scrfd as tscrfd
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)

CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "facedet_tpu", "eval", "assets", "scrfd_2_5g_golden.npz",
)


def seeded_variables(variables, seed: int, gain: float = 1.5) -> dict:
    """A flax variable tree refilled from seeded numpy, keeping shapes:
    kernels N(0, gain^2/fan_in), biases N(0, 0.1), scales in
    [0.5, 1.5], running means N(0, 0.2), running vars in [0.5, 2]. Flax's
    own init leaves biases 0 and statistics trivial, which would hide a
    swapped or dropped leaf."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "kernel":
            qkv = len(shape) == 3 and path[-2].key != "out"  # attention [D, H, dh]
            fan_in = shape[0] if qkv else int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) * gain * fan_in**-0.5).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == "mean":
            return (rng.standard_normal(shape) * 0.2).astype(np.float32)
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)  # biases, bare tables

    return jax.tree_util.tree_map_with_path(fill, jax.tree.map(np.asarray, dict(variables)))


def _maps_close(got, want, atol):
    assert len(got) == len(want) == 3
    for lg, lw in zip(got, want):
        assert set(lg) == set(lw) == {"cls", "box", "kps"}
        for k in lw:
            assert lg[k].dtype == torch.float32
            assert tuple(lg[k].shape) == tuple(lw[k].shape)
            np.testing.assert_allclose(lg[k].numpy(), np.asarray(lw[k]), atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def small():
    """scrfd_500m, seeded weights, through both forwards at 72x104."""
    cfg = jax_scrfd.SCRFD_VARIANTS["scrfd_500m"]
    jm = jax_scrfd.Scrfd(cfg)
    variables = seeded_variables(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False), 11)
    x = np.random.default_rng(12).random((2, 72, 104, 3), np.float32)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    tm = tscrfd.Scrfd(tscrfd.SCRFD_VARIANTS["scrfd_500m"])
    from_jax.load_jax_variables(tm, variables)
    with torch.inference_mode():
        got = tm.set_dtypes().eval()(torch.from_numpy(x))
    return variables, want, got


def test_variant_tables_equal_the_jax_package():
    assert set(tscrfd.SCRFD_VARIANTS) == set(jax_scrfd.SCRFD_VARIANTS)
    for name, cfg in jax_scrfd.SCRFD_VARIANTS.items():
        assert dataclasses.asdict(tscrfd.SCRFD_VARIANTS[name]) == dataclasses.asdict(cfg)
    assert tscrfd.STRIDES == jax_scrfd.STRIDES and tscrfd.NUM_ANCHORS == jax_scrfd.NUM_ANCHORS


def test_raw_maps_match_flax_on_odd_feature_maps(small):
    _, want, got = small
    assert [tuple(l["cls"].shape[1:3]) for l in got] == [(9, 13), (5, 7), (3, 4)]
    _maps_close(got, want, 1e-4)


def test_golden_checkpoint_loads_by_name_and_maps_match_flax():
    tree = from_jax.load_params_npz(CKPT)
    state = from_jax.from_jax_variables(tree)
    assert len(state) == 203
    assert state["backbone.s0_b0.Conv_2.weight"].shape == (28, 28, 1, 1)
    tm = tscrfd.Scrfd(tscrfd.SCRFD_VARIANTS["scrfd_2.5g"])
    from_jax.load_jax_variables(tm, tree)  # strict: raises on a missing or extra key
    x = np.stack([
        synthetic_faces(64, 64, seed=3, n=1, size=(20, 30)),
        np.random.default_rng(4).integers(0, 256, (64, 64, 3)),
    ]).astype(np.float32) / 255.0
    want = jax_scrfd.Scrfd(jax_scrfd.SCRFD_VARIANTS["scrfd_2.5g"]).apply(tree, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = tm.set_dtypes().eval()(torch.from_numpy(x))
    _maps_close(got, want, 1e-4)


def test_loader_is_strict_for_scrfd():
    tree = from_jax.load_params_npz(CKPT)
    del tree["params"]["head"]["l0_gn0"]["scale"]
    with pytest.raises(KeyError, match="missing"):
        from_jax.load_jax_variables(tscrfd.Scrfd(tscrfd.SCRFD_VARIANTS["scrfd_2.5g"]), tree)
    with pytest.raises(KeyError, match="missing|extra"):  # another variant's tree does not fit
        from_jax.load_jax_variables(tscrfd.Scrfd(tscrfd.SCRFD_VARIANTS["scrfd_500m"]), from_jax.load_params_npz(CKPT))


def _seeded_levels(seed, b=2, hw=((5, 7), (3, 4), (2, 2))):
    rng = np.random.default_rng(seed)
    return [
        {
            "cls": rng.standard_normal((b, h, w, 2)).astype(np.float32),
            "box": rng.random((b, h, w, 8), np.float32) * 3,
            "kps": rng.standard_normal((b, h, w, 20)).astype(np.float32),
        }
        for h, w in hw
    ]


def test_decode_scrfd_matches_jax():
    levels = _seeded_levels(5)
    want = jax_scrfd.decode_scrfd([{k: jnp.asarray(v) for k, v in l.items()} for l in levels])
    got = tscrfd.decode_scrfd([{k: torch.from_numpy(v) for k, v in l.items()} for l in levels])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("with_kps", [True, False])
def test_decode_scrfd_flat_matches_jax(with_kps):
    """The insightface output order at a 40x56 input (5x7, 3x4, 2x2 maps)."""
    levels = _seeded_levels(6)
    b = 2
    outs = [1 / (1 + np.exp(-l["cls"].reshape(b, -1, 1))) for l in levels]
    outs += [l["box"].reshape(b, -1, 4) for l in levels]
    if with_kps:
        outs += [l["kps"].reshape(b, -1, 10) for l in levels]
    want = jax_scrfd.decode_scrfd_flat(tuple(jnp.asarray(o) for o in outs), (40, 56))
    got = tscrfd.decode_scrfd_flat(tuple(torch.from_numpy(o.astype(np.float32)) for o in outs), (40, 56))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="expected 6 or 9"):
        tscrfd.decode_scrfd_flat(tuple(torch.zeros(1, 4, 1) for _ in range(5)), (40, 56))


def test_tile_forward_matches_jax_with_golden_weights():
    kw = dict(model_path=CKPT, variant="scrfd_2.5g", dtype="float32", confidence_threshold=0.3)
    jm = JaxScrfdModel(**kw)
    tm = ScrfdDetectionModel(device="cpu", **kw)
    tiles = np.stack([
        synthetic_faces(128, 128, seed=7, n=2, size=(40, 60)),
        synthetic_faces(128, 128, seed=8, n=1, size=(44, 62)),
    ]).astype(np.float32) / 255.0
    conf = 0.02  # the golden net is a short demo training: keep enough rows to compare
    want = jm.tile_forward(jm.variables, jnp.asarray(tiles), conf)
    got = tm.forward_tiles(torch.from_numpy(tiles), conf)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert v.sum() > 0
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], atol=0.05)
    np.testing.assert_allclose(got.scores.numpy()[v], np.asarray(want.scores)[v], atol=1e-3)
    np.testing.assert_allclose(got.kpts.numpy()[v][..., :2], np.asarray(want.kpts)[v][..., :2], atol=0.1)
    # NCHW tiles, as the sliced pipeline gathers them, give the same
    nchw = tm.tile_forward_nchw(torch.from_numpy(tiles).permute(0, 3, 1, 2), conf)
    assert torch.equal(nchw.boxes, got.boxes) and torch.equal(nchw.valid, got.valid)


def test_random_init_is_seeded_and_bfloat16_keeps_float32_norms():
    a = ScrfdDetectionModel(variant="scrfd_500m", seed=5, device="cpu")
    b = ScrfdDetectionModel(variant="scrfd_500m", seed=5, device="cpu")
    c = ScrfdDetectionModel(variant="scrfd_500m", seed=6, device="cpu")
    w = a.model.backbone.stem.weight
    assert a.dtype == "bfloat16" and w.dtype == torch.bfloat16
    assert a.model.backbone.stem_bn.running_var.dtype == torch.float32
    assert a.model.head.l0_gn0.weight.dtype == torch.float32 and a.model.head.l0_gn0.eps == 1e-6
    assert torch.equal(w, b.model.backbone.stem.weight) and not torch.equal(w, c.model.backbone.stem.weight)
    det = a.forward_tiles(torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(0)))
    assert det.boxes.shape == (1, 168, 4) and det.boxes.dtype == torch.float32
    assert bool(torch.isfinite(det.boxes).all())
    m = tscrfd.create_scrfd(tscrfd.SCRFD_VARIANTS["scrfd_500m"], seed=5)
    assert torch.equal(m.backbone.stem.weight.to(torch.bfloat16), w)  # float32 config, same draws
    with pytest.raises(ValueError, match="unsupported checkpoint"):
        ScrfdDetectionModel(model_path="weights.pt", device="cpu")


def test_face_analysis_guard_and_clamp():
    fa = FaceAnalysis(name="no-such-variant", model_path=CKPT, device="cpu")
    assert fa.variant == "scrfd_2.5g"
    fa.prepare(det_size=(0, 0), det_thresh=0.02)
    assert fa.det_size == (640, 640) and fa._model.image_size == 640
    fa.prepare(det_size=(128, 96), det_thresh=0.02)
    assert fa.det_size == (128, 96) and fa._model.image_size == 128
    image = synthetic_faces(96, 128, seed=9, n=2, size=(30, 46))
    faces = fa.get(image)
    assert faces and all(isinstance(f, Face) for f in faces)
    for f in faces:
        assert f.kps.shape == (5, 2) and f.det_score >= 0.02
        assert (f.bbox >= 0).all() and f.bbox[2] <= 128 and f.bbox[3] <= 96
    assert [f.det_score for f in faces] == sorted((f.det_score for f in faces), reverse=True)
