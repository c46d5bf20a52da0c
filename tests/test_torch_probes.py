"""The six probes of facedet_tpu_torch/tools/ on the CPU, against the port's
production ops where the JAX variant is a closure inside its ``main()``, and
against the JAX package where it is a function of its module.

- ``probe_rgb_stage`` (float32): ``planar_fma`` equals ``current`` (the
  production ``yuv420_to_rgb_chw``) within 1e-6 (a matmul and
  multiply-adds round differently); ``fma_noclip`` equals it where the pixel
  is in gamut and leaves [0, 1] where it is not; ``nearest_fma`` differs by
  more than 0.05 somewhere (fidelity-changing, as JAX's docstring says).
- ``probe_idct_layout``: on real coefficient planes, ``current`` is the
  production decode exactly, ``separable`` equals it within 1e-3 gray levels
  (float32 in another order), ``bf16_matmul`` within 3 (bfloat16's
  relative spacing of 2^-8 over the 64-term sum).
- ``probe_unpack_fusion``: ``blockmajor`` and ``permscatter`` give the
  production coefficient planes exactly, and so does ``current``.
  ``pack_order`` packs with the production packer: where no gap exceeds
  65,534 its first entries equal JAX's ``pack_order`` byte for byte, and
  one more entry parks the position. A fault of JAX's pack (ROADMAP.md §3):
  a longer gap wraps in its uint16, so its wire unpacks to the wrong planes,
  and the port's does not.
- ``probe_stream_window``: windows 2, 3 and 4 give the same stream results.
- ``probe_sr_tiling``: the ``planned`` plan equals ``FaceEnhancer``'s output
  exactly (the same function).
- ``probe_sr_e2e``: the staged cycle writes ``enhance_to_jpeg``'s bytes.
- Every tool's ``main`` runs on ``cuda`` by default and raises without a card.
"""
import importlib
import os

import numpy as np
import pytest
import torch

from facedet_tpu.tools.probe_unpack_fusion import pack_order as jax_pack_order
from facedet_tpu_torch.ops.jpeg_dct import _idct_plane, encode_dct420, unpack_sparse_ac, unpack_sparse_ac_np
from facedet_tpu_torch.tools import probe_idct_layout as pil
from facedet_tpu_torch.tools import probe_rgb_stage as prs
from facedet_tpu_torch.tools import probe_sr_e2e as pse
from facedet_tpu_torch.tools import probe_sr_tiling as pst
from facedet_tpu_torch.tools import probe_stream_window as psw
from facedet_tpu_torch.tools import probe_unpack_fusion as puf
from facedet_tpu_torch.utils.synth import bench_image, synthetic_faces

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")
TOOLS = ["profile_stages", "profile_layers", "profile_modules", "profile_sr_layers", "probe_rgb_stage",
         "probe_idct_layout", "probe_unpack_fusion", "probe_stream_window", "probe_sr_tiling", "probe_sr_e2e"]


@pytest.fixture(scope="module")
def yuv():
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.integers(0, 256, (2, 32, 48)).astype(np.float32))
    uv = torch.from_numpy(rng.integers(0, 256, (2, 16, 24, 2)).astype(np.float32))
    return y, uv


def test_planar_fma_equals_current(yuv):
    y, uv = yuv
    cur = prs.VARIANTS["current"](y, uv, torch.float32)
    np.testing.assert_allclose(prs.VARIANTS["planar_fma"](y, uv, torch.float32).numpy(), cur.numpy(), atol=1e-6)


def test_fma_noclip_equals_current_in_gamut(yuv):
    y, uv = yuv
    cur = prs.VARIANTS["current"](y, uv, torch.float32)
    raw = prs.VARIANTS["fma_noclip"](y, uv, torch.float32)
    inside = (raw >= 0) & (raw <= 1)
    assert 0 < int(inside.sum()) < raw.numel()
    np.testing.assert_allclose(raw[inside].numpy(), cur[inside].numpy(), atol=1e-6)
    assert float((raw - cur).abs().max()) > 0.05


def test_nearest_fma_is_fidelity_changing(yuv):
    y, uv = yuv
    cur = prs.VARIANTS["current"](y, uv, torch.float32)
    near = prs.VARIANTS["nearest_fma"](y, uv, torch.float32)
    assert "nearest_fma" in prs.FIDELITY_CHANGING and float((near - cur).abs().max()) > 0.05


@pytest.fixture(scope="module")
def luma():
    d = encode_dct420(synthetic_faces(128, 192, seed=2, n=3, size=(20, 40)), quality=90)
    dc = torch.from_numpy(np.stack([d.y_dc] * 2))
    ac = torch.from_numpy(np.stack([d.y_ac] * 2))
    return dc, ac, torch.from_numpy(d.qy)


@pytest.mark.parametrize("variant,tol", [("current", 0.0), ("separable", 1e-3), ("bf16_matmul", 3.0)])
def test_idct_variants_equal_the_production_decode(luma, variant, tol):
    dc, ac, q = luma
    want = _idct_plane(dc, ac, q)
    got = pil.VARIANTS[variant](dc, ac, q)
    assert got.shape == want.shape and float((got - want).abs().max()) <= tol


def test_idct_partial_rows_run(luma):
    dc, ac, q = luma
    assert pil.upcast(dc, ac, q).shape == ac.shape
    assert pil.matmul(dc, ac, q).shape == (2, ac.shape[1] * ac.shape[2], 64)


@pytest.fixture(scope="module")
def wires():
    d = encode_dct420(puf._natural_image(128, 192), quality=90)
    flat_c, flat_b = puf.flat_orders(d)
    cap = ((flat_c.size // 4) + 7) & ~7
    packed = {o: puf.pack_order(f, cap) for o, f in (("coef", flat_c), ("block", flat_b))}
    return d, flat_c, flat_b, cap, packed


@pytest.mark.parametrize("variant", puf.VARIANTS)
def test_unpack_variants_give_the_production_planes(wires, variant):
    d, flat_c, _, _, packed = wires
    hb, wb = d.y_ac.shape[:2]
    deltas, vals, _ = packed["block" if variant == "blockmajor" else "coef"]
    t = lambda a: torch.from_numpy(np.stack([a] * 2))  # noqa: E731
    got = puf.luma_planes(variant, t(deltas.view(np.int16)), t(vals), flat_c.size, hb, wb)
    # the production decode's planes (engine/predict.decode_canvas)
    flat = unpack_sparse_ac(t(packed["coef"][0].view(np.int16)), t(packed["coef"][1]), flat_c.size)
    want = flat[..., : 64 * hb * wb].reshape(2, 64, hb, wb).movedim(1, -1)
    assert torch.equal(got, want) and torch.equal(want[0], torch.from_numpy(d.y_ac))


@pytest.mark.parametrize("order", ["coef", "block"])
def test_pack_order_is_jax_pack_order_where_the_gaps_fit(wires, order):
    _, flat_c, flat_b, cap, packed = wires
    flat = flat_c if order == "coef" else flat_b
    assert np.diff(np.flatnonzero(flat), prepend=-1).max() <= 65534
    deltas, vals, nnz = packed[order]
    jd, jv, jn = jax_pack_order(flat, cap)
    assert nnz == jn and deltas[:nnz].tobytes() == jd[:nnz].tobytes() and vals.tobytes() == jv.tobytes()
    assert not jd[nnz:].any() and deltas[nnz] > 0 and not deltas[nnz + 1:].any()


def test_jax_pack_order_wraps_a_long_gap_and_the_port_does_not():
    flat = np.zeros(200_000, np.int8)
    flat[[5, 150_000, 199_990]] = [3, -2, 7]
    cap = 64
    jd, jv, _ = jax_pack_order(flat, cap)
    assert not np.array_equal(unpack_sparse_ac_np(jd, jv, flat.size), flat)
    deltas, vals, nnz = puf.pack_order(flat, cap)
    assert nnz == 3 and np.array_equal(unpack_sparse_ac_np(deltas, vals, flat.size), flat)


def test_stream_windows_give_the_same_results():
    from facedet_tpu_torch import YoloV11PoseDetectionModel

    model = YoloV11PoseDetectionModel(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.15,
                                      image_size=160, device="cpu")
    images = [encode_dct420(synthetic_faces(240, 256, seed=s, n=4, size=(30, 60))) for s in (1, 3, 4)]
    cfg = dict(psw.CFG, slice_height=160, slice_width=160)
    runs = {w: psw.run_window(images, model, 2, w, cfg)[0] for w in (2, 3, 4)}
    assert len(runs[2]) == 2 and int(runs[2][0].valid.sum()) > 0
    assert psw.same_results(runs[3], runs[2]) and psw.same_results(runs[4], runs[2])


@pytest.fixture(scope="module")
def enhancer():
    from facedet_tpu_torch.engine.enhancer import FaceEnhancer

    return FaceEnhancer("RealESRGAN_x4plus", tile=24, tile_pad=4, device="cpu")


def test_planned_sr_plan_is_the_enhancers_output(enhancer):
    img = torch.from_numpy(bench_image(32, 48).astype(np.float32) / 255.0)
    chw = img.permute(2, 0, 1).contiguous()
    plans = pst.plans(enhancer, enhancer.tile, enhancer.tile_pad, enhancer.max_tiles_per_batch)
    with torch.inference_mode():
        planned = plans["planned"](chw)
        want = enhancer.enhance_array(img).permute(2, 0, 1)
        whole, legacy = plans["whole"](chw), plans["legacy4x420"](chw)
    assert torch.equal(planned, want)
    assert whole.shape == legacy.shape == planned.shape == (3, 128, 192)
    fid = pst.fidelity(legacy, whole)
    assert 0 < fid["max"] <= 1 and 0 <= fid["frac_over_1_255"] < 1


def test_sr_e2e_stages_write_enhance_to_jpegs_bytes(enhancer, tmp_path):
    from facedet_tpu_torch.utils.viz import save_image

    src = str(tmp_path / "in.jpg")
    save_image(src, bench_image(32, 48), quality=92)
    enhancer.enhance_to_jpeg(src, str(tmp_path / "e.jpg"), quality=95, sparse=True)
    sec, info = pse.staged_cycle(enhancer, src, str(tmp_path / "s.jpg"), 4.0, 95)
    assert set(sec) == set(pse.STAGES) and all(v >= 0 for v in sec.values())
    assert (tmp_path / "s.jpg").read_bytes() == (tmp_path / "e.jpg").read_bytes()
    assert info["sparse"] == ("sparse_overflow" not in enhancer.last_fetch)


@pytest.mark.parametrize("tool", TOOLS)
def test_every_tool_runs_on_the_card_by_default_and_raises_without_one(monkeypatch, tool):
    module = importlib.import_module(f"facedet_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([]) if tool == "probe_sr_e2e" else module.main()


def test_sr_e2e_main_holds_the_staged_cycles_against_the_end_to_end_ones():
    res = pse.main(["--device", "cpu", "--hw", "32,48", "--n", "2"])
    cycles = res["cycles_ms"]
    assert len(cycles["e2e"]) == len(cycles["staged"]) == 2 and res["same_bytes"]
    assert res["staged_over_e2e"] == pytest.approx(sum(cycles["staged"]) / sum(cycles["e2e"]), rel=1e-2)
    assert res["sum_ms"] == pytest.approx(sum(res["stages_ms"].values()))
