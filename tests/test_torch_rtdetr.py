"""The port's RT-DETR (models/rtdetr.py, engine/rtdetr_wrapper.py) against the
flax model on the CPU in float32, part by part and as a whole, with seeded
weights carried across by ``models/from_jax.py`` (flax's own init leaves the
encoder scores nearly equal, so a last-digit difference would move a token
across the cut of the query selection; seeded weights spread them).

Tolerances: ``sincos_pos_embed_2d`` 1e-6; ``_bilinear_sample`` and
``MsDeformAttn`` 1e-5 (``grid_sample`` goes through normalised coordinates,
which costs about 1e-5 px at these map sizes); ``Aifi``, ``Ccff`` and one
``DecoderLayer`` 1e-4; the whole ``rtdetr-tiny``: equal ``top_idx``, logits
1e-4, boxes 1e-5; the wrapper: equal keep masks, boxes 0.05 px, scores 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.engine.rtdetr_wrapper import RtDetrDetectionModel as JaxRtDetrModel
from facedet_tpu.models import rtdetr as jax_rtdetr
from facedet_tpu_torch.engine.rtdetr_wrapper import FaceDetector, RtDetrDetectionModel
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models import rtdetr as trt
from test_torch_scrfd import seeded_variables

torch.set_num_threads(1)

JCFG = jax_rtdetr.RTDETR_VARIANTS["rtdetr-tiny"]
TCFG = trt.RTDETR_VARIANTS["rtdetr-tiny"]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _carry(jax_module, torch_module, seed, *args, gain=1.5):
    """Init the flax module on ``args``, refill its variables from seeded
    numpy, load them into the torch module; returns the variables."""
    variables = seeded_variables(jax_module.init(jax.random.PRNGKey(0), *args), seed, gain)
    from_jax.load_jax_variables(torch_module, variables)
    torch_module.eval()
    return variables


def save_flat_npz(path, variables, drop=()):
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        key = "/".join(p.key for p in kp)
        if key not in drop:
            flat[key] = np.asarray(leaf)
    np.savez(path, **flat)


def test_variant_tables_equal_the_jax_package():
    assert set(trt.RTDETR_VARIANTS) == set(jax_rtdetr.RTDETR_VARIANTS)
    for name, cfg in jax_rtdetr.RTDETR_VARIANTS.items():
        assert dataclasses.asdict(trt.RTDETR_VARIANTS[name]) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("h,w,dim", [(2, 3, 64), (20, 20, 256)])
def test_sincos_pos_embed_matches_jax(h, w, dim):
    want = np.asarray(jax_rtdetr.sincos_pos_embed_2d(h, w, dim))
    got = trt.sincos_pos_embed_2d(h, w, dim).numpy()
    assert got.shape == want.shape == (h * w, dim)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_inverse_sigmoid_clips_at_1e5():
    x = np.array([0.0, 1e-7, 0.3, 1.0 - 1e-7, 1.0], np.float32)
    np.testing.assert_allclose(
        trt.inverse_sigmoid(torch.from_numpy(x)).numpy(), np.asarray(jax_rtdetr.inverse_sigmoid(jnp.asarray(x))), atol=1e-5
    )


def test_bilinear_sample_matches_jax_with_points_outside():
    rng = np.random.default_rng(20)
    feat = rng.standard_normal((7, 9, 6)).astype(np.float32)
    coords = np.concatenate([
        rng.uniform([-2.0, -2.0], [11.0, 9.0], (60, 2)),
        [[-1.0, 3.0], [8.0, 6.0], [8.5, 6.5], [-0.5, -0.5], [0.0, 0.0], [3.0, 2.0], [9.0, 7.0]],
    ]).astype(np.float32)
    want = np.asarray(jax_rtdetr._bilinear_sample(jnp.asarray(feat), jnp.asarray(coords)))
    got = trt._bilinear_sample(torch.from_numpy(feat), torch.from_numpy(coords)).numpy()
    assert (want[np.all((coords < -1) | (coords > 10), axis=1)] == 0).all()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _deform_inputs(seed, q=10):
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((2, q, 64)).astype(np.float32)
    ref = np.concatenate([rng.uniform(-0.1, 1.1, (2, q, 2)), rng.uniform(0.05, 0.6, (2, q, 2))], -1).astype(np.float32)
    feats = [rng.standard_normal((2, h, w, 64)).astype(np.float32) for h, w in ((8, 12), (4, 6), (2, 3))]
    return query, ref, feats


def test_ms_deform_attn_matches_jax():
    query, ref, feats = _deform_inputs(21)
    jm, tm = jax_rtdetr.MsDeformAttn(JCFG), trt.MsDeformAttn(TCFG)
    jargs = (jnp.asarray(query), jnp.asarray(ref), [jnp.asarray(f) for f in feats])
    variables = _carry(jm, tm, 22, *jargs)
    want = np.asarray(jm.apply(variables, *jargs))
    with torch.inference_mode():
        got = tm(torch.from_numpy(query), torch.from_numpy(ref), [_nchw(f) for f in feats]).numpy()
    assert got.shape == want.shape == (2, 10, 64)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_aifi_matches_jax():
    x = np.random.default_rng(23).standard_normal((2, 2, 3, 64)).astype(np.float32)
    jm, tm = jax_rtdetr.Aifi(JCFG), trt.Aifi(TCFG)
    variables = _carry(jm, tm, 24, jnp.asarray(x))
    assert tm.ln1.eps == 1e-6
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = _nhwc(tm(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_ccff_matches_jax_on_odd_maps():
    """9x13 / 5x7 / 3x4 maps: the nearest resize has a ratio that is not a
    whole number (floor((i+0.5)*in/out): torch's nearest-exact)."""
    rng = np.random.default_rng(25)
    feats = [rng.standard_normal((2, h, w, c)).astype(np.float32) for (h, w), c in zip(((9, 13), (5, 7), (3, 4)), JCFG.backbone_widths[1:])]
    jm, tm = jax_rtdetr.Ccff(JCFG), trt.Ccff(TCFG)
    jfeats = [jnp.asarray(f) for f in feats]
    variables = _carry(jm, tm, 26, jfeats)
    want = jm.apply(variables, jfeats)
    with torch.inference_mode():
        got = tm([_nchw(f) for f in feats])
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=1e-4)


def test_decoder_layer_matches_jax():
    query, ref, feats = _deform_inputs(27)
    ref = np.clip(ref, 0.02, 0.98)
    qpos = np.random.default_rng(28).standard_normal(query.shape).astype(np.float32)
    jm, tm = jax_rtdetr.DecoderLayer(JCFG), trt.DecoderLayer(TCFG)
    jargs = (jnp.asarray(query), jnp.asarray(ref), [jnp.asarray(f) for f in feats], jnp.asarray(qpos))
    variables = _carry(jm, tm, 29, *jargs)
    want = np.asarray(jm.apply(variables, *jargs))
    with torch.inference_mode():
        got = tm(torch.from_numpy(query), torch.from_numpy(ref), [_nchw(f) for f in feats], torch.from_numpy(qpos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_attention_mask_true_means_may_attend():
    """The flax convention: a query that may attend to one key only returns
    that key's value row."""
    tm = trt.MultiHeadAttention(8, 2).eval()
    x = torch.randn(1, 3, 8, generator=torch.Generator().manual_seed(0))
    mask = torch.zeros(1, 1, 3, 3, dtype=torch.bool)
    mask[..., 1] = True
    with torch.inference_mode():
        got = tm(x, x, x, mask=mask)
        want = tm.out(tm.value(x[:, 1:2])).expand(-1, 3, -1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def whole():
    jm, tm = jax_rtdetr.RtDetr(JCFG), trt.RtDetr(TCFG)
    variables = _carry(jm, tm, 30, jnp.zeros((1, 64, 64, 3)), gain=1.0)
    return jm, tm.set_dtypes(), variables


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_whole_forward_matches_jax(whole, hw):
    jm, tm, variables = whole
    x = np.random.default_rng(31).random((2, *hw, 3), np.float32)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    n_tokens = sum(-(-hw[0] // s) * -(-hw[1] // s) for s in (8, 16, 32))
    assert got["enc_logits"].shape == (2, n_tokens, 1)
    np.testing.assert_allclose(got["enc_logits"].numpy(), np.asarray(want["enc_logits"]), atol=1e-4)
    np.testing.assert_allclose(got["enc_boxes"].numpy(), np.asarray(want["enc_boxes"]), atol=1e-5)
    score = np.asarray(want["enc_logits"]).max(-1)
    want_idx = np.asarray(jax.lax.top_k(jnp.asarray(score), JCFG.num_queries)[1])
    np.testing.assert_array_equal(got["top_idx"].numpy(), want_idx)
    assert len(got["logits"]) == len(want["logits"]) == JCFG.num_decoder_layers
    for g, w in zip(got["logits"], want["logits"]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    for g, w in zip(got["boxes"], want["boxes"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    # the selection can be given: the same tokens in another order give the
    # same set of predictions
    with torch.inference_mode():
        flipped = tm(torch.from_numpy(x), top_idx=got["top_idx"].flip(1))
    np.testing.assert_allclose(flipped["boxes"][-1].flip(1).numpy(), got["boxes"][-1].numpy(), atol=1e-5)


def test_decode_rtdetr_matches_jax():
    rng = np.random.default_rng(32)
    outs = {"logits": [rng.standard_normal((2, 7, 1)).astype(np.float32)], "boxes": [rng.random((2, 7, 4), np.float32)]}
    want = jax_rtdetr.decode_rtdetr({k: [jnp.asarray(v[0])] for k, v in outs.items()}, 96)
    got = trt.decode_rtdetr({k: [torch.from_numpy(v[0])] for k, v in outs.items()}, 96)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5)


def test_wrapper_detections_match_jax_and_a_checkpoint_without_dn_embed_loads(whole, tmp_path):
    _, _, variables = whole
    full, legacy = str(tmp_path / "rtdetr.npz"), str(tmp_path / "rtdetr_legacy.npz")
    save_flat_npz(full, variables)
    save_flat_npz(legacy, variables, drop=("params/dn_embed",))
    kw = dict(variant="rtdetr-tiny", dtype="float32", confidence_threshold=0.3)
    jm = JaxRtDetrModel(model_path=full, **kw)
    tm = RtDetrDetectionModel(model_path=full, device="cpu", **kw)
    tiles = np.random.default_rng(33).random((2, 64, 96, 3), np.float32)  # non-square: both axes scale by the height
    want = jm.tile_forward(jm.variables, jnp.asarray(tiles), 0.5)
    got = tm.forward_tiles(torch.from_numpy(tiles), 0.5)
    assert got.boxes.shape == (2, 60, 4) and got.kpts.shape == (2, 60, 5, 3) and not got.kpts.any()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < int(got.valid.sum()) < got.valid.numel()
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-3)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=0.05)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    assert float(got.boxes[..., 2].max()) <= 64.0 * 1.5  # x extents scale by the tile height (64), not its width

    old = RtDetrDetectionModel(model_path=legacy, device="cpu", **kw)
    assert not old.model.dn_embed.any() and tm.model.dn_embed.any()
    again = old.forward_tiles(torch.from_numpy(tiles), 0.5)
    assert torch.equal(again.boxes, got.boxes)
    with pytest.raises(KeyError):
        bad = str(tmp_path / "bad.npz")
        save_flat_npz(bad, variables, drop=("params/enc_score/bias",))
        RtDetrDetectionModel(model_path=bad, device="cpu", **kw)


def test_random_init_is_seeded_and_unported_parts_raise(tmp_path):
    a = RtDetrDetectionModel(variant="rtdetr-tiny", seed=2, device="cpu")
    b = RtDetrDetectionModel(variant="rtdetr-tiny", seed=2, device="cpu")
    m = a.model
    assert a.dtype == "bfloat16" and m.enc_score.weight.dtype == torch.bfloat16
    assert m.enc_norm.weight.dtype == torch.float32 and m.dn_embed.dtype == torch.float32 and m.dn_embed.any()
    for (ka, va), (_, vb) in zip(m.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(va, vb), ka
    det = a.forward_tiles(torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1)))
    assert det.boxes.shape == (1, 60, 4) and bool(torch.isfinite(det.boxes).all())
    # the denoising branch is ported (train/rtdetr_train.py holds it against JAX): two groups of one query pair
    outs = m(torch.zeros(1, 64, 64, 3), dn_labels=torch.tensor([[0, 1, 0, 1]]), dn_ref=torch.full((1, 4, 4), 0.5),
             dn_groups=2)
    assert outs["dn_logits"][-1].shape == (1, 4, 1) and outs["logits"][-1].shape == (1, 60, 1)
    fd = FaceDetector(variant="rtdetr-tiny", conf=0.1, image_size=64, device="cpu")
    for call in (lambda: fd.detect_video("a.avi", "b.avi"), lambda: fd.detect_webcam()):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            call()


def test_face_detector_image_and_folder_modes(tmp_path):
    from facedet_tpu_torch.utils.synth import synthetic_faces
    from facedet_tpu_torch.utils.viz import save_image

    inp = tmp_path / "in"
    inp.mkdir()
    for s in (1, 2):
        save_image(str(inp / f"f{s}.png"), synthetic_faces(96, 128, seed=s, n=1, size=(30, 46)))
    (inp / "notes.txt").write_text("skipped")
    fd = FaceDetector(variant="rtdetr-tiny", conf=0.05, image_size=64, device="cpu")
    results = fd.detect_folder(str(inp), str(tmp_path / "out"))
    assert len(results) == 2
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["f1.png", "f2.png"]
    one = fd.detect_image(str(inp / "f1.png"))
    assert len(one.object_prediction_list) == len(results[0].object_prediction_list)
