"""The port's FaceEnhancer (facedet_tpu_torch/engine/enhancer.py) against the
JAX package's on the CPU: the same seeded inputs and the same weights (the
flax variables saved as an .npz and carried across by models/from_jax.py)
through both, with a tiny RRDB config as tests/test_enhancer.py uses.

Tolerances, float32 on both sides: float outputs within 2e-5 on [0, 1]
(convs and the resampling products sum in another order); uint8 outputs equal
except where a value falls on another side of .5: at most one level, on at
most 0.1% of the values. Quantised DCT planes: at most 2e-4 of the
coefficients differ, each by one level. What moves integers or is pure
Python (the tile plan, the catalog, the stats) is equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from facedet_tpu.core.detections import Detections as JaxDetections
from facedet_tpu.engine import enhancer as jenh
from facedet_tpu.engine.detector import save_params_npz
from facedet_tpu.models.rrdbnet import RRDBConfig as JaxRRDBConfig
from facedet_tpu_torch.core.detections import Detections
from facedet_tpu_torch.engine import enhancer as tenh
from facedet_tpu_torch.models.rrdbnet import RRDBConfig
from facedet_tpu_torch.ops.kernels import tile_gather as tg
from facedet_tpu_torch.utils.viz import save_image

torch.set_num_threads(1)

DIMS = dict(num_feat=8, num_block=1, num_grow_ch=4)


def _pair(tmp_path_factory, scale, **kw):
    """(JAX enhancer, port enhancer) with the same perturbed random weights."""
    j = jenh.FaceEnhancer(cfg=JaxRRDBConfig(scale=scale, **DIMS), half=False, device="cpu", **kw)
    rng = np.random.default_rng(scale)
    j.variables = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32)), j.variables
    )
    path = str(tmp_path_factory.mktemp("weights") / f"tiny_x{scale}.npz")
    save_params_npz(path, jax.device_get(j.variables))
    t = tenh.FaceEnhancer(cfg=RRDBConfig(scale=scale, **DIMS), model_path=path, half=False, device="cpu", **kw)
    return j, t


@pytest.fixture(scope="module")
def x4(tmp_path_factory):
    return _pair(tmp_path_factory, 4, outscale=4, tile=0)


@pytest.fixture(scope="module")
def x2(tmp_path_factory):
    return _pair(tmp_path_factory, 2, outscale=2, tile=0)


def _uint8_image(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (h, w, 3)).astype(np.uint8)


def _assert_uint8_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3, (diff.max(), (diff != 0).mean())


@pytest.mark.parametrize("hw", [(512, 768), (1024, 1536), (33, 47), (400, 400), (50, 70), (2340, 4160), (2048, 3072), (128, 128)])
@pytest.mark.parametrize("budget", [(400, 10, 8), (200, 10, 8), (32, 4, 2)])
def test_plan_tile_grid_equals_jax(hw, budget):
    assert tenh.plan_tile_grid(*hw, *budget) == jenh.plan_tile_grid(*hw, *budget)


def test_plan_tile_grid_known_plans():
    assert tenh.plan_tile_grid(512, 768, 400, 10, 8) == (1, 1, 512, 768)  # one window, no halo
    assert tenh.plan_tile_grid(1024, 1536) == jenh.plan_tile_grid(1024, 1536)
    assert tenh.plan_tile_grid(500, 500, 4, 0, 1) == jenh.plan_tile_grid(500, 500, 4, 0, 1)  # the legacy grid


@pytest.mark.parametrize("tile,max_tiles", [(12, 8), (32, 2)])
def test_tiled_sr_matches_jax(x4, tile, max_tiles):
    """More tiles than a chunk holds, which every multi-tile plan has (an
    image whose windows fit one chunk fits as one window): 30 tiles in
    chunks of 8 with a last chunk of 6, and 6 tiles in chunks of 2. The JAX
    package pads the last chunk with zero tiles and maps over chunks; the
    port's last chunk is shorter."""
    j, t = x4
    img = np.random.default_rng(6).uniform(0, 1, (50, 70, 3)).astype(np.float32)
    plan = tenh.plan_tile_grid(50, 70, tile, 4, max_tiles)
    assert plan[0] * plan[1] > max_tiles
    want = np.asarray(jenh.tiled_sr(j._net, jnp.asarray(img), 4, tile=tile, tile_pad=4, max_tiles_per_batch=max_tiles))
    got = tenh.tiled_sr(
        lambda x: t._net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1), torch.from_numpy(img), 4,
        tile=tile, tile_pad=4, max_tiles_per_batch=max_tiles,
    )
    assert got.shape == (200, 280, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_tiled_sr_without_tiling_and_exact_seams():
    """tile=0 and a plan of one window call fn once on the whole image; a
    local fn (receptive field inside the halo) gives the same interior tiled
    as whole."""
    def fn(x):  # 3x3 mean, then nearest x2
        k = torch.ones(3, 1, 3, 3) / 9.0
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k, padding=1, groups=3)
        return y.repeat_interleave(2, 2).repeat_interleave(2, 3).permute(0, 2, 3, 1)

    img = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (90, 120, 3)).astype(np.float32))
    full = fn(img[None])[0]
    assert torch.equal(tenh.tiled_sr(fn, img, 2, tile=0), full)
    assert torch.equal(tenh.tiled_sr(fn, img, 2, tile=400), full)
    tiled = tenh.tiled_sr(fn, img, 2, tile=32, tile_pad=4, max_tiles_per_batch=2)
    assert tiled.shape == full.shape == (180, 240, 3)
    np.testing.assert_allclose(tiled[8:-8, 8:-8].numpy(), full[8:-8, 8:-8].numpy(), atol=1e-6)


def test_enhance_image_matches_jax(x4):
    j, t = x4
    img = _uint8_image(12, 16)
    want, _ = j.enhance_image(img)
    got, seconds = t.enhance_image(img)
    assert got.shape == (48, 64, 3) and seconds > 0
    _assert_uint8_close(got, want)
    x = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(
        t.enhance_array(torch.from_numpy(x)).numpy(), np.asarray(j.enhance_array(jnp.asarray(x))), atol=2e-5
    )
    assert t.stats["images"] == 1
    gray, _ = t.enhance_image(img[..., 0])
    rgba, _ = t.enhance_image(np.concatenate([img, img[..., :1]], -1))
    assert gray.shape == rgba.shape == (48, 64, 3)


@pytest.mark.parametrize("net,outscale", [("x4", 2.0), ("x4", 3.0), ("x2", 3.0), ("x2", 1.5)])
def test_outscale_other_than_the_nets_matches_jax(x4, x2, net, outscale):
    """The lanczos3 resize after the net, antialiased where it shrinks,
    then clipped."""
    j, t = x4 if net == "x4" else x2
    img = _uint8_image(12, 16, seed=int(outscale * 10))
    want, _ = j.enhance_image(img, outscale=outscale)
    got, _ = t.enhance_image(img, outscale=outscale)
    assert got.shape == (int(round(12 * outscale)), int(round(16 * outscale)), 3)
    _assert_uint8_close(got, want)


@pytest.mark.parametrize("hw", [(11, 13), (12, 15), (14, 14)])
def test_x2_net_odd_sizes_match_jax(x2, hw):
    """Odd sizes are reflect-padded to the pixel-unshuffle's multiple and
    the result is cut back."""
    j, t = x2
    img = _uint8_image(*hw, seed=hw[1])
    want, _ = j.enhance_image(img)
    got, _ = t.enhance_image(img)
    assert got.shape == (hw[0] * 2, hw[1] * 2, 3)
    _assert_uint8_close(got, want)


def test_tiled_enhancer_matches_jax(tmp_path_factory):
    """A multi-tile plan through FaceEnhancer, x2 net, odd size: padding for
    the unshuffle, halo windows, chunks, assembly, crop."""
    j, t = _pair(tmp_path_factory, 2, outscale=2, tile=24, tile_pad=4, max_tiles_per_batch=2)
    img = _uint8_image(45, 61, seed=8)
    before = dict(tg.LAUNCHES)
    want, _ = j.enhance_image(img)
    got, _ = t.enhance_image(img)
    assert got.shape == (90, 122, 3)
    _assert_uint8_close(got, want)
    assert tg.LAUNCHES == before  # on the CPU the windows come from the plain version: no launch is counted


def test_cascade_matches_jax(tmp_path_factory):
    """The x2 net twice for a x4 output; below s*s the cascade is off."""
    j, t = _pair(tmp_path_factory, 2, outscale=4, tile=0, cascade=True)
    img = _uint8_image(10, 12, seed=9)
    want, _ = j.enhance_image(img)
    got, _ = t.enhance_image(img)
    assert got.shape == (40, 48, 3)
    _assert_uint8_close(got, want)
    want2, _ = j.enhance_image(img, outscale=2)
    got2, _ = t.enhance_image(img, outscale=2)
    _assert_uint8_close(got2, want2)
    assert t.get_model_info() == {**j.get_model_info()}


def test_cascade_alias_and_catalog():
    assert tenh.get_available_models() == jenh.get_available_models()
    assert tenh._GOLDEN_CKPTS == jenh._GOLDEN_CKPTS and tenh._CASCADE_ALIASES == jenh._CASCADE_ALIASES
    assert tenh._SIZE_BUCKETS == jenh._SIZE_BUCKETS
    for x in (1, 32, 33, 100, 2048, 2049, 5000):
        assert tenh._bucket_dim(x) == jenh._bucket_dim(x)
    with pytest.raises(ValueError, match="unknown model"):
        tenh.FaceEnhancer(model_name="nope", device="cpu")
    for name in jenh._GOLDEN_CKPTS:
        assert os.path.samefile(tenh._golden_ckpt_path(name), jenh._golden_ckpt_path(name))
    assert tenh._golden_ckpt_path("RealESRGAN_x4plus_anime_6B") is None


def test_golden_weights_resolve_by_catalog_name_and_cpu_rule():
    """A catalog name loads the committed weights; on the CPU the compute is
    float32 and the tile at most 200, as in the JAX class."""
    enh = tenh.FaceEnhancer(model_name="RealESRGAN_x4cascade", device="cpu")
    assert enh.cascade and enh.cfg.scale == 2 and enh.cfg.dtype == "float32" and enh.tile == 200
    with np.load(tenh._golden_ckpt_path("RealESRGAN_x2plus")) as flat:
        want = flat["params/conv_first/kernel"].astype(np.float32).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(enh.model.conv_first.weight.detach().numpy(), want)
    info = enh.get_model_info()
    assert info["scale"] == 4 and info["net_scale"] == 2 and info["num_block"] == 23
    assert info["num_params"] == sum(p.numel() for p in enh.model.parameters()) > 16_000_000


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenh.FaceEnhancer(cfg=RRDBConfig(**DIMS))
    from facedet_tpu_torch.apps.common import build_enhancer
    from facedet_tpu_torch.utils.config import EnhancerConfig

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_enhancer(EnhancerConfig())


def test_random_init_is_seeded():
    cfg = RRDBConfig(**DIMS)
    a = tenh.FaceEnhancer(cfg=cfg, device="cpu")
    b = tenh.FaceEnhancer(cfg=cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    c = tenh.FaceEnhancer(cfg=cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.model.conv_last.weight, b.model.conv_last.weight)
    assert not torch.equal(a.model.conv_last.weight, c.model.conv_last.weight)


@pytest.mark.parametrize("hw", [(10, 9), (20, 33), (32, 48)])
def test_enhance_face_crop_matches_jax(x4, tmp_path, hw):
    """File to file, through the size buckets: a 10x9 crop is padded to 32x32
    by 22 and 23 pixels, more than its own size (the reflect pad repeats)."""
    j, t = x4
    src = str(tmp_path / "in.png")
    save_image(src, _uint8_image(*hw, seed=hw[0]))
    assert j.enhance_face_crop(src, str(tmp_path / "jax.png"))
    assert t.enhance_face_crop(src, str(tmp_path / "torch.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png").convert("RGB"))
    got = np.asarray(Image.open(tmp_path / "torch.png").convert("RGB"))
    assert got.shape == (hw[0] * 4, hw[1] * 4, 3)
    _assert_uint8_close(got, want)
    xj, hj, wj = j._load_bucketed(src)
    xt, ht, wt = t._load_bucketed(src)
    assert (hj, wj) == (ht, wt) == hw
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))


def _blocky_jpeg(path, seed):
    rng = np.random.default_rng(seed)
    img = np.clip(
        np.kron(rng.integers(40, 210, (5, 6, 3)), np.ones((8, 8, 1))) + rng.normal(0, 2, (40, 48, 3)), 0, 255
    ).astype(np.uint8)
    save_image(path, img, quality=95)
    return img


@pytest.mark.parametrize("sparse", [False, True])
def test_enhance_dct_pipeline_matches_jax(x4, tmp_path, sparse):
    """SR, edge pad to 16, forward DCT and quantisation (and the bitmap
    pack) against the JAX pipeline's planes."""
    j, t = x4
    src = str(tmp_path / "in.jpg")
    _blocky_jpeg(src, 3)
    xj, _, _ = j._load_bucketed(src)
    xt, _, _ = t._load_bucketed(src)
    pj, qyj, qcj, thw_j = j._enhance_dct_pipeline(48, 48, 4.0, 90, sparse=sparse)
    pt, qy, qc, thw = t._enhance_dct_pipeline(48, 48, 4.0, 90, sparse=sparse)
    np.testing.assert_array_equal(qy, qyj)
    np.testing.assert_array_equal(qc, qcj)
    assert thw == thw_j == (192, 192)
    want = [np.asarray(a) for a in pj(j.variables, xj)]
    got = [a.numpy() for a in pt(xt)]
    assert len(got) == len(want) == (6 if sparse else 5)
    assert int(got[-1]) == int(want[-1]) == 0  # n_clipped
    if sparse:
        y_dc, uv_dc, bitmap, vals, nnz = got[:5]
        n = 64 * 24 * 24 + 2 * 64 * 12 * 12
        assert bitmap.shape == (n // 8,) and vals.shape == want[3].shape and vals.dtype == np.int16
        flat = tenh_unpack(bitmap, vals, n)
        flat_j = tenh_unpack(want[2], want[3], n)
        assert int(nnz) == np.count_nonzero(flat) <= vals.shape[0]
        pairs = [(y_dc, want[0]), (uv_dc, want[1]), (flat, flat_j)]
        assert abs(int(nnz) - int(want[4])) <= 2e-4 * n
    else:
        pairs = list(zip(got[:4], want[:4]))
    for g, w in pairs:
        assert g.shape == w.shape and g.dtype == w.dtype
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1 and (diff != 0).mean() <= 2e-4, (diff.max(), (diff != 0).mean())


def tenh_unpack(bitmap, vals, n):
    from facedet_tpu_torch.ops.jpeg_dct import unpack_sparse_bitmap_np

    return unpack_sparse_bitmap_np(bitmap, vals, n)


def test_enhance_to_jpeg_dense_sparse_and_pixels(x4, tmp_path):
    """The coefficient fetch writes a real .jpg close to the pixel fetch
    (quality-90 quantisation and 4:2:0 chroma apart); the sparse wire is
    transport only: byte-equal pixels to the dense fetch; and both equal the
    JAX package's files where the planes are equal."""
    j, t = x4
    src = str(tmp_path / "in.jpg")
    _blocky_jpeg(src, 5)
    out = {k: str(tmp_path / f"{k}.jpg") for k in ("dense", "sparse", "jax_dense")}
    assert t.enhance_to_jpeg(src, out["dense"], quality=90)
    dense_info = dict(t.last_fetch)
    assert t.enhance_to_jpeg(src, out["sparse"], quality=90, sparse=True)
    sparse_info = dict(t.last_fetch)
    assert j.enhance_to_jpeg(src, out["jax_dense"], quality=90)
    a, b, c = (np.asarray(Image.open(out[k]).convert("RGB")) for k in ("dense", "sparse", "jax_dense"))
    assert a.shape == b.shape == (160, 192, 3)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a.astype(int) - c.astype(int)).mean() < 0.05  # a few coefficients may differ by a level
    ref, _ = t.enhance_image(np.asarray(Image.open(src).convert("RGB")))
    assert np.abs(a.astype(float) - ref.astype(float)).mean() < 4.0
    assert dense_info["branch"].startswith("coefficients") and dense_info["n_clipped"] == 0 and not dense_info["sparse"]
    assert sparse_info["sparse"] and 0 < sparse_info["nnz"] <= sparse_info["cap"]
    assert sparse_info["bytes_fetched"] < dense_info["bytes_fetched"] < 192 * 192 * 3 * 4


def test_enhance_to_jpeg_fallbacks(x4, tmp_path, monkeypatch):
    """The JAX package's own fall-backs: density above the cap -> the dense
    fetch; clipped coefficients -> the pixel fetch; no native writer -> the
    planes decoded on the host."""
    from facedet_tpu_torch.data import native_loader
    from facedet_tpu_torch.ops import jpeg_dct

    _, t = x4
    src = str(tmp_path / "in.jpg")
    _blocky_jpeg(src, 7)
    dst = str(tmp_path / "out.jpg")
    real_pack = jpeg_dct.pack_sparse_bitmap_device
    monkeypatch.setattr(jpeg_dct, "pack_sparse_bitmap_device", lambda flat, cap: real_pack(flat, 8))
    assert t.enhance_to_jpeg(src, dst, quality=90, sparse=True)
    assert not t.last_fetch["sparse"] and t.last_fetch["sparse_overflow"]["nnz"] > 8
    monkeypatch.undo()

    real_encode = jpeg_dct.encode_dct420_device

    def clipped(*a, **k):
        planes = real_encode(*a, **k)
        return (*planes[:4], planes[4] + 3)

    monkeypatch.setattr(jpeg_dct, "encode_dct420_device", clipped)
    for sparse in (False, True):
        assert t.enhance_to_jpeg(src, dst, quality=90, sparse=sparse)
        assert t.last_fetch["branch"].startswith("pixels") and t.last_fetch["n_clipped"] == 3
    monkeypatch.undo()

    monkeypatch.setattr(native_loader, "save_dct420_jpeg", lambda path, d: False)
    assert t.enhance_to_jpeg(src, dst, quality=90)
    assert "decoded on the host" in t.last_fetch["branch"]
    assert np.asarray(Image.open(dst)).shape == (160, 192, 3)


def test_enhance_detections_matches_jax(x4, x2):
    """Crop on the device, batch at crop_size, run the net; more crops than
    one net call takes."""
    img = np.random.default_rng(10).uniform(0, 1, (64, 96, 3)).astype(np.float32)
    boxes = np.array([[10, 12, 40, 44], [-8, -5, 20, 18], [2, 1, 92, 62], [0, 0, 0, 0], [30, 8, 50, 20]], np.float32)
    n = len(boxes)
    fields = dict(scores=np.ones(n, np.float32), classes=np.zeros(n, np.int32),
                  kpts=np.zeros((n, 5, 3), np.float32), valid=np.ones(n, bool))
    dj = JaxDetections(boxes=jnp.asarray(boxes), **{k: jnp.asarray(v) for k, v in fields.items()})
    dt = Detections(boxes=torch.from_numpy(boxes), **{k: torch.from_numpy(v) for k, v in fields.items()})
    for (j, t), scale in ((x4, 4), (x2, 2)):
        want = np.asarray(j.enhance_detections(jnp.asarray(img), dj, crop_size=16, margin=0.1))
        got = t.enhance_detections(torch.from_numpy(img), dt, crop_size=16, margin=0.1)
        assert got.shape == (n, 16 * scale, 16 * scale, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    j, t = x4
    t.tile, t.tile_pad, t.max_tiles_per_batch = 8, 4, 2  # a budget of two 16x16 crops a call
    try:
        chunked = t.enhance_detections(torch.from_numpy(img), dt, crop_size=16, margin=0.1)
    finally:
        t.tile, t.tile_pad, t.max_tiles_per_batch = 0, 10, 8
    want = np.asarray(j.enhance_detections(jnp.asarray(img), dj, crop_size=16, margin=0.1))
    np.testing.assert_allclose(chunked.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("fetch", ["rgb", "dct420", "dct420s"])
def test_crops_batch_and_summary_match_jax(x4, tmp_path, fetch):
    j, t = x4
    crops = tmp_path / "crops"
    crops.mkdir()
    for i in range(3):
        save_image(str(crops / f"face_{i}_conf_0.90.jpg"), _uint8_image(10 + i, 9, seed=i) // 2 + 60)
    save_image(str(crops / "face_3.png"), _uint8_image(12, 12, seed=3))
    (crops / "notes.txt").write_text("not an image")
    (crops / "broken.jpg").write_bytes(b"not a jpeg")
    stats = tenh.enhance_face_crops_batch(str(crops), str(tmp_path / "torch"), t, fetch=fetch)
    want = jenh.enhance_face_crops_batch(str(crops), str(tmp_path / "jax"), j, fetch=fetch)
    for k in ("total", "enhanced", "failed", "failed_files"):
        assert stats[k] == want[k], k
    assert stats["total"] == 5 and stats["enhanced"] == 4 and stats["failed_files"] == ["broken.jpg"]
    for name in ("face_0_conf_0.90.jpg", "face_3.png"):
        a = np.asarray(Image.open(tmp_path / "torch" / name).convert("RGB"))
        b = np.asarray(Image.open(tmp_path / "jax" / name).convert("RGB"))
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).mean() < 0.05
    report = tenh.create_enhancement_summary(stats, str(tmp_path / "summary.txt"), model_info=t.get_model_info())
    assert "Enhanced: 4" in report and "Failed files: broken.jpg" in report and "num_params" in report
    assert (tmp_path / "summary.txt").read_text() == report
    stats["seconds"] = want["seconds"] = 0.0
    assert report.split("Elapsed")[0] == jenh.create_enhancement_summary(want).split("Elapsed")[0]
