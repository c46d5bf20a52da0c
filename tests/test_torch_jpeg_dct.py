"""The port's quantized-DCT ingest (facedet_tpu_torch/ops/jpeg_dct.py, the
staging of engine/predict.py and data/native_loader.py) against the JAX
package's on the CPU, on seeded numpy inputs.

Tolerances: host numpy functions are copies and must give equal arrays
(``array_equal``): the encoder, the sparse pack (numpy and native), the wire,
``_stage_batch_host`` and the loaders. Integer planes rebuilt on tensors
(``unpack_sparse_ac``, ``wire_unpack_dct420s``) are exact.
``decode_dct420_to_yuv_f32`` in float32: 255e-5 on [0, 255] (a 64-term
float32 product summed in another order); in bfloat16: one bfloat16 step at
255 (1.0), since both packages compute in float32 and round once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.data import native_loader as jloader
from facedet_tpu.engine import predict as jpredict
from facedet_tpu.ops import jpeg_dct as jdct
from facedet_tpu.ops.color import rgb_to_yuv420
from facedet_tpu_torch.data import native_loader as tloader
from facedet_tpu_torch.engine import predict as tpredict
from facedet_tpu_torch.ops import jpeg_dct as tdct

torch.set_num_threads(1)

PLANES = ("y_dc", "y_ac", "uv_dc", "uv_ac", "qy", "qc")


def natural_image(h, w, seed=0):
    """tests/test_jpeg_dct.py's image: blocky smooth noise plus fine noise."""
    rng = np.random.default_rng(seed)
    base = np.kron(
        rng.standard_normal((h // 16 + 1, w // 16 + 1)).astype(np.float32),
        np.ones((16, 16), np.float32),
    )[:h, :w]
    base = base + 0.15 * rng.standard_normal((h, w)).astype(np.float32)
    base = (base - base.min()) / (base.max() - base.min())
    return np.stack([base * 255, base * 230 + 10, base * 210 + 25], -1).astype(np.uint8)


def _assert_same_dct(a, b):
    for f in PLANES:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert tuple(a.hw) == tuple(b.hw)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# --- host functions: equal arrays --------------------------------------------------


def test_tables_and_bytes_equal():
    np.testing.assert_array_equal(tdct._C, jdct._C)
    np.testing.assert_array_equal(tdct._IDCT64, jdct._IDCT64)
    for q in (1, 10, 49, 50, 75, 90, 95, 100):
        for a, b in zip(tdct.quality_tables(q), jdct.quality_tables(q)):
            np.testing.assert_array_equal(a, b)
    assert tdct.dct420_bytes(1024, 1536) == jdct.dct420_bytes(1024, 1536)
    assert tdct._wire_sections(3, 256, 512) == jdct._wire_sections(3, 256, 512)
    assert tdct._DELTA_MAX == jdct._DELTA_MAX


@pytest.mark.parametrize("case", ["rgb", "odd_size", "planes", "pad_to", "quality50"])
def test_encode_dct420_equals_jax_host_function(case):
    img = natural_image(97, 133, seed=2) if case == "odd_size" else natural_image(96, 128, seed=1)
    kw = {"pad_to": (128, 256)} if case == "pad_to" else {"quality": 50} if case == "quality50" else {}
    src = rgb_to_yuv420(img) if case == "planes" else img
    got, want = tdct.encode_dct420(src, **kw), jdct.encode_dct420(src, **kw)
    _assert_same_dct(got, want)
    for a, b in zip(tdct.decode_dct420_np(got), jdct.decode_dct420_np(want)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="multiple of 16"):
        tdct.encode_dct420(img, pad_to=(100, 256))


def test_sparse_pack_host_functions_equal():
    rng = np.random.default_rng(3)
    flat = np.where(rng.random(8192) < 0.12, rng.integers(-127, 128, 8192), 0).astype(np.int8)
    far = np.zeros(200_000, np.int8)
    for pos, v in ((0, 5), (70_000, -3), (199_999, 7)):  # gaps straddle 65534
        far[pos] = v
    for arr in (flat, far, np.zeros(1024, np.int8)):
        n_t, n_j = tdct.sparse_nnz_entries(arr), jdct.sparse_nnz_entries(arr)
        assert n_t == n_j
        cap = tdct.sparse_cap_bucket(n_t, arr.size)
        assert cap == jdct.sparse_cap_bucket(n_j, arr.size)
        for a, b in zip(tdct.pack_sparse_ac(arr, cap), jdct.pack_sparse_ac(arr, cap)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        d, v = tdct.pack_sparse_ac(arr, cap)
        np.testing.assert_array_equal(tdct.unpack_sparse_ac_np(d, v, arr.size), arr)
    for n in (0, 1, 4096, 65537, (1 << 20) - 1, 1 << 20):
        assert tdct.sparse_cap_bucket(n, 1 << 20) == jdct.sparse_cap_bucket(n, 1 << 20)
    with pytest.raises(ValueError, match="capacity"):
        tdct.pack_sparse_ac(np.ones(8192, np.int8), 4096)


def _pack_batch_input():
    """tests/test_jpeg_dct.py:316-341's batch: photo-like density, dummy
    gaps, an empty image, a tail nonzero, a head nonzero, a sparse one."""
    rng = np.random.default_rng(11)
    total = 180_000
    flat2d = np.zeros((6, total), np.int8)
    flat2d[0] = np.where(rng.random(total) < 0.15, rng.integers(-127, 128, total), 0)
    flat2d[1, ::70_001] = 3
    flat2d[3, total - 1] = -9
    flat2d[4, 0] = 1
    flat2d[5] = np.where(rng.random(total) < 0.003, rng.integers(-127, 128, total), 0)
    return flat2d


def test_pack_sparse_ac_batch_native_and_numpy_equal_jax():
    flat2d = _pack_batch_input()
    want_d, want_v = jdct.pack_sparse_ac_batch(flat2d)
    assert tdct._load_pack_native() is not None  # this host has g++: the native path runs
    got_d, got_v = tdct.pack_sparse_ac_batch(flat2d)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_v, want_v)
    for i in range(6):
        np.testing.assert_array_equal(tdct.unpack_sparse_ac_np(got_d[i], got_v[i], flat2d.shape[1]), flat2d[i])


def test_pack_sparse_ac_batch_numpy_path_when_no_compiler(monkeypatch):
    """Without ``g++`` the numpy path serves, with the same output, and the
    caller's ``alloc`` receives the shared capacity."""
    flat2d = _pack_batch_input()
    want_d, want_v = tdct.pack_sparse_ac_batch(flat2d)
    monkeypatch.setattr(tdct, "_load_pack_native", lambda: None)
    seen = []

    def alloc(cap):
        seen.append(cap)
        return np.empty((6, cap), np.uint16), np.empty((6, cap), np.int8)

    got_d, got_v = tdct.pack_sparse_ac_batch(flat2d, alloc=alloc)
    assert seen == [want_d.shape[1]]
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_v, want_v)


def _dct_batch(n=3, hw=(120, 200)):
    rng = np.random.default_rng(5)
    return [rng.integers(0, 255, (*hw, 3)).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("fmt", ["rgb", "yuv420", "dct420", "dct420s"])
def test_stage_batch_host_equals_jax(fmt):
    """tests/test_jpeg_dct.py:359-397: the staged upload arrays, padding
    regions included (canvas 128x256 forces right and bottom padding)."""
    raw = _dct_batch()
    if fmt == "rgb":
        t_imgs = j_imgs = raw
    elif fmt == "yuv420":
        t_imgs = j_imgs = [rgb_to_yuv420(im) for im in raw]
    else:
        t_imgs = [tdct.encode_dct420(im) for im in raw]
        j_imgs = [jdct.encode_dct420(im) for im in raw]
    got = tpredict._stage_batch_host(t_imgs, fmt, 128, 256)
    want = jpredict._stage_batch_host(j_imgs, fmt, 128, 256)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_stage_batch_host_writes_every_byte_of_dirty_buffers():
    """The staging fills only the padding strips; with an allocator that
    hands out dirty memory the result must not change."""
    imgs = [tdct.encode_dct420(im) for im in _dct_batch()]

    def dirty(shape, dtype):
        return np.full(shape, 77, dtype)

    for fmt, src in (("dct420s", imgs), ("dct420", imgs), ("yuv420", _dct_batch()), ("rgb", _dct_batch())):
        clean = tpredict._stage_batch_host(src, fmt, 128, 256)
        got = tpredict._stage_batch_host(src, fmt, 128, 256, alloc=dirty)
        for a, b in zip(*((clean, got) if isinstance(clean, tuple) else ((clean,), (got,)))):
            np.testing.assert_array_equal(a, b)


def test_stage_sparse_matches_dense_planes():
    """The sparse wire carries the dense staging's AC bytes exactly."""
    imgs = [tdct.encode_dct420(im) for im in _dct_batch()]
    y_dc_d, y_ac_d, uv_dc_d, uv_ac_d, qy_d, qc_d = tpredict._stage_batch_host(imgs, "dct420", 128, 256)
    wire = tpredict._stage_batch_host(imgs, "dct420s", 128, 256)
    assert wire.dtype == np.uint8 and wire.ndim == 1
    y_dc_s, uv_dc_s, qy_s, qc_s, deltas, vals = tdct.wire_unpack_dct420s_np(wire, 3, 128, 256)
    for a, b in ((y_dc_d, y_dc_s), (uv_dc_d, uv_dc_s), (qy_d, qy_s), (qc_d, qc_s)):
        np.testing.assert_array_equal(a, b)
    total = y_ac_d[0].size + uv_ac_d[0].size
    for i in range(3):
        flat_ref = np.concatenate([y_ac_d[i].ravel(), uv_ac_d[i].ravel()])
        np.testing.assert_array_equal(tdct.unpack_sparse_ac_np(deltas[i], vals[i], total), flat_ref)


def test_padding_is_black_luma_neutral_chroma():
    """tests/test_jpeg_dct.py:67-78."""
    d = tdct.encode_dct420(natural_image(40, 56, seed=5), quality=90)
    y_dc, y_ac, uv_dc, uv_ac, qy, qc = (a[0] for a in tpredict._stage_batch_host([d], "dct420", 128, 128))
    # the AC planes leave the staging coefficient-major: back to block-major
    planes = (y_dc, np.moveaxis(y_ac, 0, -1), uv_dc, np.moveaxis(uv_ac, (0, 1), (2, 3)), qy, qc)
    for a, b in zip(planes, jpredict._pad_dct_planes(jdct.encode_dct420(natural_image(40, 56, seed=5)), 128, 128)):
        np.testing.assert_array_equal(a, b)
    y, uv = tdct.decode_dct420_np(tdct.DctImage(*planes[:4], d.qy, d.qc, (128, 128)))
    assert y[100:, 100:].mean() < 6.0
    assert abs(float(uv[40:, 40:].mean()) - 128.0) < 2.0


# --- tensor functions against JAX --------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_dct420_matches_jax(dtype):
    d = tdct.encode_dct420(natural_image(64, 80, seed=3), quality=85)
    planes = [getattr(d, f) for f in PLANES]
    t_dt, j_dt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    want = jdct.decode_dct420_to_yuv_f32(*(jnp.asarray(p) for p in planes), out_dtype=j_dt)
    got = tdct.decode_dct420_to_yuv_f32(*_t(*planes), out_dtype=t_dt)
    atol = 255e-5 if dtype == "float32" else 1.0
    for g, w, shape in zip(got, want, ((64, 80), (32, 40, 2))):
        assert g.shape == shape and g.dtype == t_dt
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)), atol=atol, rtol=0)
    # tests/test_jpeg_dct.py:55-64: within the rounding step of the host decode
    y_np, uv_np = tdct.decode_dct420_np(d)
    y32, uv32 = tdct.decode_dct420_to_yuv_f32(*_t(*planes))
    assert np.abs(y32.numpy() - y_np.astype(np.float32)).max() <= 0.51
    assert np.abs(uv32.numpy() - uv_np.astype(np.float32)).max() <= 0.51


def test_decode_dct420_batch_axis_equals_per_image():
    ds = [tdct.encode_dct420(natural_image(48, 64, seed=s)) for s in range(3)]
    stacked = [np.stack([getattr(d, f) for d in ds]) for f in PLANES]
    y_b, uv_b = tdct.decode_dct420_to_yuv_f32(*_t(*stacked))
    assert y_b.shape == (3, 48, 64) and uv_b.shape == (3, 24, 32, 2)
    for i, d in enumerate(ds):
        y, uv = tdct.decode_dct420_to_yuv_f32(*_t(*(getattr(d, f) for f in PLANES)))
        np.testing.assert_allclose(y_b[i].numpy(), y.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(uv_b[i].numpy(), uv.numpy(), atol=1e-4, rtol=0)


def test_sparse_ac_roundtrip_matches_jax():
    """tests/test_jpeg_dct.py:259-280."""
    rng = np.random.default_rng(3)
    flat = np.where(rng.random(8192) < 0.12, rng.integers(-127, 128, 8192), 0).astype(np.int8)
    cap = tdct.sparse_cap_bucket(tdct.sparse_nnz_entries(flat), flat.size)
    deltas, vals = tdct.pack_sparse_ac(flat, cap)
    assert deltas.size == vals.size == cap and deltas.dtype == np.uint16
    want = np.asarray(jdct.unpack_sparse_ac(jnp.asarray(deltas), jnp.asarray(vals), flat.size))
    got = tdct.unpack_sparse_ac(*_t(deltas, vals), flat.size)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), flat)
    # the int16 bits of the deltas decode alike (how they travel to the device)
    bits = tdct.unpack_sparse_ac(*_t(deltas.view(np.int16), vals), flat.size)
    np.testing.assert_array_equal(bits.numpy(), flat)
    with pytest.raises(TypeError):
        tdct.unpack_sparse_ac(torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int8), 8)


def test_sparse_ac_delta_overflow_and_edges():
    """tests/test_jpeg_dct.py:283-313: dummy entries for zero runs past the
    uint16 range (deltas above 32767 are negative as int16 bits), the
    all-zero input, and the padding after the parking entry."""
    n = 200_000
    flat = np.zeros(n, np.int8)
    for pos, v in ((0, 5), (70_000, -3), (199_999, 7)):
        flat[pos] = v
    entries = tdct.sparse_nnz_entries(flat)
    assert entries > 4
    deltas, vals = tdct.pack_sparse_ac(flat, entries)
    assert deltas.max() > 32767
    np.testing.assert_array_equal(tdct.unpack_sparse_ac(*_t(deltas, vals), n).numpy(), flat)
    z = np.zeros(1024, np.int8)
    dz, vz = tdct.pack_sparse_ac(z, 8)
    np.testing.assert_array_equal(tdct.unpack_sparse_ac(*_t(dz, vz), z.size).numpy(), z)
    tail = np.zeros(100, np.int8)
    tail[99] = 9
    dt, vt = tdct.pack_sparse_ac(tail, 64)
    np.testing.assert_array_equal(tdct.unpack_sparse_ac(*_t(dt, vt), 100).numpy(), tail)


def test_sparse_ac_batch_axis():
    flat2d = _pack_batch_input()
    deltas, vals = tdct.pack_sparse_ac_batch(flat2d)
    got = tdct.unpack_sparse_ac(*_t(deltas, vals), flat2d.shape[1])
    assert got.shape == flat2d.shape
    np.testing.assert_array_equal(got.numpy(), flat2d)


def test_wire_unpack_matches_jax_and_host_views():
    imgs = [tdct.encode_dct420(im) for im in _dct_batch()]
    wire = tpredict._stage_batch_host(imgs, "dct420s", 128, 256)
    host = tdct.wire_unpack_dct420s_np(wire, 3, 128, 256)
    want = jdct.wire_unpack_dct420s(jnp.asarray(wire), 3, 128, 256)
    got = tdct.wire_unpack_dct420s(torch.from_numpy(wire), 3, 128, 256)
    dtypes = (torch.int16, torch.int16, torch.float32, torch.float32, torch.uint16, torch.int8)
    for g, w, h, dt in zip(got, want, host, dtypes):
        assert g.dtype == dt and tuple(g.shape) == h.shape
        np.testing.assert_array_equal(g.numpy(), h)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the pack helper gives the same wire as the direct staging
    np.testing.assert_array_equal(tdct.wire_pack_dct420s(*host), wire)
    np.testing.assert_array_equal(jdct.wire_pack_dct420s(*host), wire)


def test_wire_unpack_copies_sections_that_start_off_their_element_size():
    """A wire whose float32 sections do not start at a multiple of 4 (here a
    buffer that itself starts 2 bytes into its storage) is still unpacked,
    by copying the section."""
    n, bh, bw = 1, 16, 48
    rng = np.random.default_rng(0)
    y_dc = rng.integers(-500, 500, (n, 2, 6)).astype(np.int16)
    uv_dc = rng.integers(-500, 500, (n, 1, 3, 2)).astype(np.int16)  # 12 bytes: qy starts at 36
    qy, qc = (rng.random((n, 64)).astype(np.float32) for _ in range(2))
    deltas = rng.integers(0, 60000, (n, 8)).astype(np.uint16)
    vals = rng.integers(-127, 128, (n, 8)).astype(np.int8)
    wire = tdct.wire_pack_dct420s(y_dc, uv_dc, qy, qc, deltas, vals)
    # two spare bytes in front put every later section off a multiple of 4
    shifted = torch.from_numpy(np.concatenate([np.zeros(2, np.uint8), wire]))[2:]
    for g, h in zip(tdct.wire_unpack_dct420s(shifted, n, bh, bw), (y_dc, uv_dc, qy, qc, deltas, vals)):
        np.testing.assert_array_equal(g.numpy(), h)


# --- the loaders -------------------------------------------------------------------


def test_loaders_equal_jax_on_a_420_jpeg(tmp_path):
    """tests/test_jpeg_dct.py:127-161 and tests/test_color.py:131-151: the
    stored coefficients and the raw YUV planes of a real 4:2:0 file."""
    from PIL import Image

    img = natural_image(97, 133, seed=3)
    path = str(tmp_path / "f.jpg")
    Image.fromarray(img).save(path, quality=90, subsampling=2)
    assert tloader._load_native() is not None  # libjpeg is on this host: the native path runs
    d = tloader.load_image_dct420(path)
    _assert_same_dct(d, jloader.load_image_dct420(path))
    assert d.hw == (97, 133) and d.y_dc.shape == (14, 18)
    np.testing.assert_array_equal(d.qy, tdct.quality_tables(90)[0])
    with open(path, "rb") as f:
        _assert_same_dct(tloader.decode_jpeg_bytes_dct420(f.read()), d)
    for a, b in zip(tloader.load_image_yuv420(path), jloader.load_image_yuv420(path)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tloader.load_image(path), jloader.load_image(path))
    got = list(tloader.prefetch_images([path, str(tmp_path / "missing.jpg")], num_workers=2))
    assert got[0][0] == path and got[0][1].shape == (97, 133, 3) and got[1][1] is None


@pytest.mark.parametrize("kind", ["jpeg444", "png", "q100_overflow"])
def test_loaders_pil_path_equals_jax(tmp_path, kind):
    """tests/test_jpeg_dct.py:164-198: files the raw paths refuse (not 4:2:0,
    not a JPEG, stored AC outside int8) decode through PIL and re-encode at
    quality 90."""
    from PIL import Image

    if kind == "q100_overflow":
        rng = np.random.default_rng(7)
        img = np.repeat((rng.integers(0, 2, (64, 64, 1)) * 255).astype(np.uint8), 3, axis=2)
        path = str(tmp_path / "q100.jpg")
        Image.fromarray(img).save(path, quality=100, subsampling=2)
    else:
        img = natural_image(64, 80, seed=5)
        path = str(tmp_path / ("f444.jpg" if kind == "jpeg444" else "f.png"))
        Image.fromarray(img).save(path, **({"quality": 95, "subsampling": 0} if kind == "jpeg444" else {}))
    d = tloader.load_image_dct420(path)
    _assert_same_dct(d, jloader.load_image_dct420(path))
    np.testing.assert_array_equal(d.qy, tdct.quality_tables(90)[0])  # the re-encode's tables
    for a, b in zip(tloader.load_image_yuv420(path), jloader.load_image_yuv420(path)):
        np.testing.assert_array_equal(a, b)
    assert tloader.load_image_dct420(str(tmp_path / "missing.jpg")) is None


def test_loaders_without_libjpeg_take_pil(tmp_path, monkeypatch):
    from PIL import Image

    img = natural_image(64, 80, seed=6)
    path = str(tmp_path / "g.jpg")
    Image.fromarray(img).save(path, quality=90, subsampling=2)
    monkeypatch.setattr(tloader, "_load_native", lambda: None)
    assert tloader.load_image_native(path) is None
    rgb = tloader.load_image(path)
    np.testing.assert_array_equal(rgb, np.asarray(Image.open(path).convert("RGB")))
    _assert_same_dct(tloader.load_image_dct420(path), tdct.encode_dct420(rgb))
    assert not tloader.save_dct420_jpeg(str(tmp_path / "w.jpg"), tdct.encode_dct420(rgb))


def test_native_jpeg_writer_roundtrip(tmp_path):
    """tests/test_jpeg_dct.py:201-228."""
    d = tdct.encode_dct420(natural_image(100, 130, seed=9), quality=90)
    path = str(tmp_path / "w.jpg")
    assert tloader.save_dct420_jpeg(path, d)
    d2 = tloader.load_image_dct420(path)
    assert d2.hw == (100, 130)
    np.testing.assert_array_equal(d.qy, d2.qy)
    rb, cb = -(-100 // 8), -(-130 // 8)
    np.testing.assert_array_equal(d.y_dc[:rb, :cb], d2.y_dc[:rb, :cb])
    np.testing.assert_array_equal(d.y_ac[:rb, :cb], d2.y_ac[:rb, :cb])


# --- the fetch half: device-side encode and the sparse-bitmap wire ----------
#
# ``encode_dct420_device`` quantises: ``round(coef / q)`` flips where the
# float32 products of the two frameworks (summed in another order) fall on
# different sides of a rounding boundary. So the planes agree except for a
# stated share of coefficients (at most 2e-4 of them here), each by one
# level; ``n_clipped`` counts coefficients far beyond the limit and is equal.
# The bitmap pack and its inverses move integers and are exact.


def _sharp_image(h, w, seed=0):
    """Float RGB in [0, 1] with hard edges, so that AC coefficients leave
    the int8 range at quality 95."""
    rng = np.random.default_rng(seed)
    base = natural_image(h, w, seed).astype(np.float32) / 255.0
    mask = np.kron(rng.integers(0, 2, (h // 4, w // 4)), np.ones((4, 4)))[..., None].astype(np.float32)
    return np.clip(base * 0.3 + mask * 0.9 * rng.uniform(0.5, 1.0, (1, 1, 3)).astype(np.float32), 0, 1).astype(np.float32)


def _plane_mismatch(got, want):
    """(share of differing entries, largest difference)."""
    diff = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want).astype(np.int64))
    return float((diff != 0).mean()), int(diff.max())


@pytest.mark.parametrize("wide_ac", [False, True])
@pytest.mark.parametrize("quality", [90, 95])
def test_encode_dct420_device_matches_jax(wide_ac, quality):
    rgb = _sharp_image(48, 64, seed=quality)
    qy, qc = tdct.quality_tables(quality)
    want = jdct.encode_dct420_device(jnp.asarray(rgb), jnp.asarray(qy), jnp.asarray(qc), wide_ac=wide_ac)
    got = tdct.encode_dct420_device(torch.from_numpy(rgb), qy, qc, wide_ac=wide_ac)
    names = ("y_dc", "y_ac", "uv_dc", "uv_ac")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype), name
        share, worst = _plane_mismatch(g.numpy(), w)
        assert share <= 2e-4 and worst <= 1, (name, share, worst)
    assert got[1].dtype == (torch.int16 if wide_ac else torch.int8)
    assert got[1].shape == (64, 6, 8) and got[3].shape == (2, 64, 3, 4)
    assert int(got[4]) == int(want[4]) and got[4].dtype == torch.int32
    if not wide_ac:
        assert int(got[4]) > 0  # the narrow wire clips this image: the caller must see it
    else:
        assert int(got[4]) == 0 and int(got[1].abs().max()) > 127  # and the wide wire carries it
    assert int(got[1][0].abs().max()) == 0 and int(got[3][:, 0].abs().max()) == 0  # slot 0 holds no AC


def test_encode_dct420_device_inverts_through_the_ingest_decode():
    """Encode on the device, carry the planes to a DctImage on the host,
    decode: the image comes back to JPEG-quality-90 fidelity."""
    rgb = natural_image(32, 48, seed=3).astype(np.float32) / 255.0
    qy, qc = tdct.quality_tables(90)
    *planes, n_clipped = tdct.encode_dct420_device(torch.from_numpy(rgb), qy, qc, wide_ac=True)
    assert int(n_clipped) == 0
    d = tdct.wire_planes_to_dct_image(planes, qy, qc, (30, 47))
    want = jdct.wire_planes_to_dct_image([p.numpy() for p in planes], qy, qc, (30, 47))
    for f in PLANES:
        np.testing.assert_array_equal(getattr(d, f), getattr(want, f))
    assert d.hw == (30, 47) and d.y_ac.shape == (4, 6, 64) and d.uv_ac.shape == (2, 3, 2, 64)
    back = tpredict._display_image(d)
    assert back.shape == (30, 47, 3)
    assert np.abs(back.astype(np.float32) / 255.0 - rgb[:30, :47]).mean() < 0.02


@pytest.mark.parametrize("dtype", ["int8", "int16"])
@pytest.mark.parametrize("density,cap", [(0.05, 256), (0.3, 64), (0.0, 8), (1.0, 4096)])
def test_pack_sparse_bitmap_matches_jax_and_inverts(dtype, density, cap):
    """Below the cap the host inverse rebuilds the input; above it the true
    nnz still comes back, so the caller can tell."""
    rng = np.random.default_rng(int(density * 100) + cap)
    n = 4096
    lim = 127 if dtype == "int8" else 1023
    flat = (rng.integers(1, lim + 1, n) * rng.choice([-1, 1], n) * (rng.uniform(size=n) < density)).astype(dtype)
    want = jdct.pack_sparse_bitmap_device(jnp.asarray(flat), cap)
    got = tdct.pack_sparse_bitmap_device(torch.from_numpy(flat), cap)
    nnz = int(np.count_nonzero(flat))
    assert int(got[2]) == int(want[2]) == nnz and got[2].dtype == torch.int32
    assert got[0].dtype == torch.uint8 and got[0].shape == (n // 8,)
    assert got[1].shape == (cap,) and str(got[1].dtype).split(".")[-1] == dtype
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[0].numpy(), np.packbits(flat != 0))  # big-endian bits
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if nnz <= cap:
        np.testing.assert_array_equal(tdct.unpack_sparse_bitmap_np(got[0], got[1], n), flat)
        np.testing.assert_array_equal(jdct.unpack_sparse_bitmap_np(got[0].numpy(), got[1].numpy(), n), flat)
    else:
        np.testing.assert_array_equal(got[1].numpy(), flat[flat != 0][:cap])


def test_pack_sparse_bitmap_of_an_empty_plane():
    bitmap, vals, nnz = tdct.pack_sparse_bitmap_device(torch.zeros(0, dtype=torch.int16), 8)
    assert bitmap.shape == (0,) and vals.shape == (8,) and int(nnz) == 0
