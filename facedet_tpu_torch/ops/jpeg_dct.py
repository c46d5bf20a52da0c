"""Quantized-DCT image transport: the ``dct420`` and ``dct420s`` input
formats, and the same coefficients as a fetch format for enhanced images.

Counterpart of facedet_tpu/ops/jpeg_dct.py. Ingest: the host uploads the
*quantized 8x8 DCT coefficients*, the representation JPEG files store, and
dequantisation and the inverse DCT run on the device: one [N,64] @ [64,64]
float32 product per plane. Fetch (``encode_dct420_device``,
``pack_sparse_bitmap_device`` and their host inverses): a super-resolved
image is transformed and quantised on the device and comes back as
coefficient planes, dense or as a bitmap and packed values, which the host
entropy-codes into a .jpg without touching a pixel.

Layout per image (``DctImage``):
  y_dc  [Hb, Wb]        int16: DC (exact; its range exceeds int8)
  y_ac  [Hb, Wb, 64]    int8: AC quantized, slot 0 zeroed, clipped to +-127
  uv_dc [Hb2, Wb2, 2]   int16
  uv_ac [Hb2, Wb2, 2, 64] int8
  qy/qc [64]            float32 quant tables (per image: real JPEG files
                        carry their own tables; libjpeg's FDCT uses the
                        orthonormal scaling used here, so file coefficients
                        are drop-in compatible)

Lossy-ness contract: encoding from raw RGB at ``quality`` (default 90) loses
what a quality-90 JPEG save loses (plus rare AC clips at +-127); when the
source is a JPEG read as coefficients, the path is lossless relative to the
file.

The host functions are numpy, copied from the JAX module and bit-identical
to it. ``_idct_plane``, ``decode_dct420_to_yuv_f32`` and ``unpack_sparse_ac``
run on tensors with any number of leading batch axes;
``wire_unpack_dct420s`` cuts one uploaded byte buffer into typed views.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from facedet_tpu_torch.ops.color import _FWD, rgb_to_yuv420
from facedet_tpu_torch.utils.native import load_native

__all__ = [
    "DctImage",
    "quality_tables",
    "encode_dct420",
    "decode_dct420_to_yuv_f32",
    "decode_dct420_np",
    "encode_dct420_device",
    "wire_planes_to_dct_image",
    "pack_sparse_bitmap_device",
    "unpack_sparse_bitmap_np",
    "dct420_bytes",
    "sparse_cap_bucket",
    "sparse_nnz_entries",
    "pack_sparse_ac",
    "pack_sparse_ac_batch",
    "unpack_sparse_ac",
    "unpack_sparse_ac_np",
    "wire_pack_dct420s",
    "wire_unpack_dct420s",
    "wire_unpack_dct420s_np",
]

# IJG standard base tables (Annex K of the JPEG spec)
_BASE_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.float32)
_BASE_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], np.float32)


def _dct_matrix() -> np.ndarray:
    """Orthonormal type-II DCT matrix (8x8), with the scaling of libjpeg's
    FDCT (jfdctint.c), so real-file coefficients decode with the same math."""
    n = 8
    k = np.arange(n)
    c = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    c[0] /= np.sqrt(2.0)
    return c.astype(np.float32)


_C = _dct_matrix()
# Fused IDCT basis: vec(C^T X C) = vec(X) @ kron(C, C). One [N, 64] @ [64, 64]
# product per plane instead of two 8x8 products per block.
_IDCT64 = np.kron(_C, _C).astype(np.float32)  # [(j,k), (i,l)] = C[j,i] * C[k,l]


def quality_tables(quality: int = 90) -> tuple[np.ndarray, np.ndarray]:
    """IJG quality scaling -> (luma [64], chroma [64]) float32 tables."""
    q = max(1, min(100, int(quality)))
    scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
    def tbl(base):
        return np.clip(np.floor((base * scale + 50.0) / 100.0), 1.0, 255.0)
    return tbl(_BASE_LUMA).astype(np.float32), tbl(_BASE_CHROMA).astype(np.float32)


@dataclasses.dataclass
class DctImage:
    """One image as quantized 4:2:0 DCT planes + its true pixel size."""

    y_dc: np.ndarray
    y_ac: np.ndarray
    uv_dc: np.ndarray
    uv_ac: np.ndarray
    qy: np.ndarray
    qc: np.ndarray
    hw: tuple[int, int]


def _blockify(plane: np.ndarray) -> np.ndarray:
    """[H, W] (H, W % 8 == 0) -> [H/8, W/8, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _quantize_plane(plane: np.ndarray, q: np.ndarray):
    """Float plane (already level-shifted by -128) -> (dc int16, ac int8)."""
    blocks = _blockify(plane)
    coef = np.einsum("ij,byjk,lk->byil", _C, blocks, _C)
    cq = np.round(coef.reshape(*coef.shape[:2], 64) / q)
    dc = np.clip(cq[..., 0], -(1 << 15), (1 << 15) - 1).astype(np.int16)
    ac = np.clip(cq, -127, 127).astype(np.int8)
    ac[..., 0] = 0
    return dc, ac


def encode_dct420(image, quality: int = 90, pad_to: tuple[int, int] | None = None) -> DctImage:
    """uint8 RGB [H,W,3] (or (Y, UV) planes) -> :class:`DctImage`.

    ``pad_to`` zero-pads (black luma / neutral chroma) to a bucketed canvas
    BEFORE the transform so padded blocks carry near-zero coefficients, the
    coefficient-space equivalent of the YUV path's padded canvas."""
    if isinstance(image, tuple):
        y, uv = image
    else:
        y, uv = rgb_to_yuv420(np.asarray(image))
    h, w = y.shape
    if pad_to is not None:
        ph, pw = pad_to
    else:
        ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    if ph % 16 or pw % 16:
        raise ValueError(f"dct420 canvas must be a multiple of 16, got {(ph, pw)}")
    y_p = np.zeros((ph, pw), np.float32)
    y_p[:h, :w] = y
    uv_p = np.full((ph // 2, pw // 2, 2), 128.0, np.float32)
    uv_p[: uv.shape[0], : uv.shape[1]] = uv

    qy, qc = quality_tables(quality)
    y_dc, y_ac = _quantize_plane(y_p - 128.0, qy)
    u_dc, u_ac = _quantize_plane(uv_p[..., 0] - 128.0, qc)
    v_dc, v_ac = _quantize_plane(uv_p[..., 1] - 128.0, qc)
    return DctImage(
        y_dc=y_dc,
        y_ac=y_ac,
        uv_dc=np.stack([u_dc, v_dc], axis=2),
        uv_ac=np.stack([u_ac, v_ac], axis=2),
        qy=qy,
        qc=qc,
        hw=(h, w),
    )


def _idct_plane(dc: torch.Tensor, ac: torch.Tensor, q: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """(dc [...,Hb,Wb] int, ac [...,Hb,Wb,64] int, q [...,64]) -> [...,H,W]
    float, level-shifted back and clipped to [0, 255]. One [N,64] @ [64,64]
    product per image, with the dequantisation folded into the basis rows.

    The product always runs in float32 (full precision: cuBLAS keeps TF32
    off for float32 matmul unless a caller turned it on); ``out_dtype`` only
    sets the stored plane. bfloat16 halves the bytes of the block-to-row
    relayout and is harmless to fidelity: pixel values live in [0, 255],
    where bfloat16's spacing is at most 1.0, the rounding every JPEG decoder
    applies when it stores uint8."""
    coef = ac.to(torch.float32, copy=True)
    coef[..., 0] = dc.to(torch.float32)
    lead, (hb, wb) = coef.shape[:-3], coef.shape[-3:-1]
    basis = q.to(torch.float32)[..., :, None] * torch.from_numpy(_IDCT64).to(q.device)
    blocks = torch.matmul(coef.reshape(*lead, hb * wb, 64), basis) + 128.0
    blocks = blocks.clamp(0.0, 255.0).to(out_dtype)
    n = len(lead)
    blocks = blocks.reshape(*lead, hb, wb, 8, 8).permute(*range(n), n, n + 2, n + 1, n + 3)
    return blocks.reshape(*lead, hb * 8, wb * 8)


def decode_dct420_to_yuv_f32(y_dc, y_ac, uv_dc, uv_ac, qy, qc, out_dtype=torch.float32):
    """Quantized planes on the device -> (Y [...,H,W], UV [...,H/2,W/2,2]) in
    ``out_dtype`` (float32, or bfloat16 for the serving canvas), the float
    inputs of ops/color.py's YUV->RGB stage."""
    y = _idct_plane(y_dc, y_ac, qy, out_dtype)
    u = _idct_plane(uv_dc[..., 0], uv_ac[..., 0, :], qc, out_dtype)
    v = _idct_plane(uv_dc[..., 1], uv_ac[..., 1, :], qc, out_dtype)
    return y, torch.stack([u, v], dim=-1)


def decode_dct420_np(img: DctImage) -> tuple[np.ndarray, np.ndarray]:
    """Host-side numpy decode (visualization/tests): -> (Y uint8 [Hp,Wp],
    UV uint8 [Hp/2,Wp/2,2]) at the padded canvas size."""
    def plane(dc, ac, q):
        coef = ac.astype(np.float32)
        coef[..., 0] = dc.astype(np.float32)
        coef = (coef * q).reshape(*coef.shape[:2], 8, 8)
        blocks = np.einsum("ji,byjk,kl->byil", _C, coef, _C)
        hb, wb = blocks.shape[:2]
        out = blocks.transpose(0, 2, 1, 3).reshape(hb * 8, wb * 8) + 128.0
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)

    y = plane(img.y_dc, img.y_ac.copy(), img.qy)
    u = plane(img.uv_dc[..., 0], img.uv_ac[..., 0, :].copy(), img.qc)
    v = plane(img.uv_dc[..., 1], img.uv_ac[..., 1, :].copy(), img.qc)
    return y, np.stack([u, v], axis=-1)


def encode_dct420_device(rgb: torch.Tensor, qy, qc, wide_ac: bool = False):
    """Forward transform on the device, the mirror of
    :func:`decode_dct420_to_yuv_f32`, for FETCHING large images (a x4
    Real-ESRGAN output holds 16x the input pixels) as quantized coefficients
    instead of raw RGB.

    ``rgb`` float [H, W, 3] in [0, 1], H and W multiples of 16; ``qy`` /
    ``qc`` float32 [64] quant tables (tensors or arrays). Returns wire-layout
    planes (y_dc int16 [Hb, Wb], y_ac int8 [64, Hb, Wb], uv_dc int16
    [Hb2, Wb2, 2], uv_ac int8 [2, 64, Hb2, Wb2]) plus ``n_clipped`` (int32
    scalar tensor: how many AC coefficients exceeded the wire range and were
    clipped). Same lossy-ness as a quality-``q`` JPEG save when
    ``n_clipped == 0``; a nonzero count means extreme-contrast blocks were
    truncated, and callers should fall back to a pixel fetch
    (engine/enhancer.py::enhance_to_jpeg does).

    ``wide_ac=True`` emits int16 AC planes clipped at JPEG baseline
    Huffman's magnitude ceiling of 1023 instead of int8 at 127: sharpened SR
    outputs overflow int8 in some blocks.

    Everything runs in float32 whatever the input dtype, and the colour and
    DCT products are exact float32 products (no TF32): a quantised
    coefficient near a rounding boundary would otherwise flip."""
    dev = rgb.device
    f32 = torch.float32
    qy = torch.as_tensor(qy, dtype=f32, device=dev)
    qc = torch.as_tensor(qc, dtype=f32, device=dev)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = rgb.to(f32) * 255.0
        ycc = torch.matmul(x, torch.from_numpy(_FWD).to(dev).t())
        y = ycc[..., 0]
        h, w = y.shape
        cb = ycc[..., 1].reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3)) + 128.0
        cr = ycc[..., 2].reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3)) + 128.0
        c = torch.from_numpy(_C).to(dev)
        ac_limit, ac_dtype = (1023.0, torch.int16) if wide_ac else (127.0, torch.int8)

        def plane(p, q):
            hb, wb = p.shape[0] // 8, p.shape[1] // 8
            blocks = p.reshape(hb, 8, wb, 8).permute(0, 2, 1, 3) - 128.0
            coef = torch.matmul(torch.matmul(c, blocks), c.t())  # C X C^T per block
            cq = torch.round(coef.reshape(hb, wb, 64) / q)
            dc = cq[..., 0].clamp(-(1 << 15), (1 << 15) - 1).to(torch.int16)
            clipped = (cq[..., 1:].abs() > ac_limit).sum(dtype=torch.int32)
            ac = cq.clamp(-ac_limit, ac_limit).to(ac_dtype)
            ac[..., 0] = 0
            return dc, ac.movedim(-1, 0).contiguous(), clipped  # wire layout

        y_dc, y_ac, y_cl = plane(y, qy)
        u_dc, u_ac, u_cl = plane(cb, qc)
        v_dc, v_ac, v_cl = plane(cr, qc)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return (
        y_dc,
        y_ac,
        torch.stack([u_dc, v_dc], dim=2),
        torch.stack([u_ac, v_ac], dim=0),
        y_cl + u_cl + v_cl,
    )


def wire_planes_to_dct_image(planes, qy, qc, hw) -> DctImage:
    """Host-side: wire-layout fetched planes (tensors or arrays) ->
    :class:`DctImage` (block-major numpy), for decode_dct420_np or the
    native JPEG writer."""
    y_dc, y_ac, uv_dc, uv_ac = (_to_numpy(p) for p in planes)
    return DctImage(
        y_dc=y_dc,
        y_ac=np.moveaxis(y_ac, 0, -1),
        uv_dc=uv_dc,
        uv_ac=np.moveaxis(uv_ac, (0, 1), (2, 3)),
        qy=np.asarray(_to_numpy(qy), np.float32),
        qc=np.asarray(_to_numpy(qc), np.float32),
        hw=tuple(hw),
    )


def _to_numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def dct420_bytes(h: int, w: int) -> int:
    """Host-to-device bytes of one dct420 image at (16-bucketed) h x w."""
    yb = (h // 8) * (w // 8)
    cb = (h // 16) * (w // 16) * 2
    return yb * 64 + yb * 2 + cb * 64 + cb * 2  # ac int8 + dc int16


# --- sparse AC wire encoding ("dct420s" ingest) -----------------------------
#
# The dense AC planes are mostly zeros. The sparse wire ships uint16 POSITION
# DELTAS between consecutive nonzeros + the int8 values, both padded to a
# bucketed capacity. The device decode is a cap-sized cumsum + scatter. Delta
# overflow (a >65534 zero run) inserts dummy entries with value 0: they
# scatter a zero onto a zero coefficient, a no-op by construction.


def sparse_cap_bucket(nnz: int, total: int) -> int:
    """Geometric capacity bucket (x1.25 steps) for the packed-values array:
    few distinct upload shapes across batches, bounded padding waste."""
    cap = max(4096, total // 64)
    while cap < nnz:
        cap = min((int(cap * 1.25) + 7) & ~7, total)
    return min(cap, total)


_DELTA_MAX = 65534  # max encodable gap; larger runs insert value-0 dummies


def sparse_nnz_entries(flat: np.ndarray, nz: np.ndarray | None = None) -> int:
    """Number of wire entries pack_sparse_ac needs for ``flat`` (true
    nonzeros + overflow dummies + the parking jump), for capacity sizing.
    Pass a precomputed ``nz = np.flatnonzero(flat)`` to share the scan with
    the subsequent pack (the scan dominates the host cost)."""
    if nz is None:
        nz = np.flatnonzero(flat)
    if nz.size == 0:
        return 1
    gaps = np.diff(nz, prepend=-1)
    return int(nz.size + ((gaps - 1) // _DELTA_MAX).sum()) + 1


def pack_sparse_ac(
    flat: np.ndarray, cap: int, nz: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Host: flat int8 AC coefficients [n] -> (position deltas uint16 [cap],
    values int8 [cap]).

    Entry k advances the write position by deltas[k] (position starts at -1)
    and writes vals[k] there. Gaps above _DELTA_MAX emit dummy entries with
    value 0: their zero lands on a zero coefficient, a no-op. After the
    last real entry one extra delta parks the position past the nonzeros so
    the zero padding tail (delta 0) rewrites a zero coefficient instead of
    the last real value; the device decode drops writes at/after slot n."""
    n = flat.size
    if nz is None:
        nz = np.flatnonzero(flat)
    gaps = np.diff(nz, prepend=-1)
    n_dummy = (gaps - 1) // _DELTA_MAX  # per real entry, preceding dummies
    total = int(nz.size + n_dummy.sum()) + 1
    if total > cap:
        raise ValueError(f"sparse AC capacity {cap} < entries {total}")
    deltas = np.zeros(cap, np.uint16)
    vals = np.zeros(cap, np.int8)
    real_pos = np.cumsum(n_dummy + 1) - 1  # wire slot of each real entry
    # dummy slots advance by the max gap; real slots carry the remainder
    deltas[: total - 1] = _DELTA_MAX
    deltas[real_pos] = gaps - n_dummy * _DELTA_MAX
    vals[real_pos] = flat[nz]
    # park the tail past the last nonzero (onto zero coefficients / the
    # dump slot) so padding entries (delta 0, val 0) stay no-ops
    prev = int(nz[-1]) if nz.size else -1
    deltas[total - 1] = min(n - prev, _DELTA_MAX)
    return deltas, vals


def _as_unsigned16(deltas: torch.Tensor) -> torch.Tensor:
    """uint16 deltas (or their int16 bits) widened to int32 in [0, 65535]:
    ``torch.uint16`` has no cumsum, so the bits are read as int16."""
    if deltas.dtype == torch.uint16:
        deltas = deltas.view(torch.int16)
    if deltas.dtype != torch.int16:
        raise TypeError(f"deltas must be uint16 or int16 bits, got {deltas.dtype}")
    return deltas.to(torch.int32) & 0xFFFF


def unpack_sparse_ac(deltas: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """Device inverse of :func:`pack_sparse_ac`: (deltas uint16 [...,cap],
    vals int8 [...,cap]) -> flat int8 [...,n].

    A cap-sized cumsum + scatter. Writes at or after slot n (the parking
    tail and the zero padding) land in a dump slot that is cut away. Writes
    collide only there or carry the value 0 onto a zero coefficient, so the
    order in which the scatter applies them does not change the result."""
    pos = torch.cumsum(_as_unsigned16(deltas), dim=-1, dtype=torch.int64) - 1
    pos = pos.clamp(max=n)  # n = dump slot
    out = torch.zeros(deltas.shape[:-1] + (n + 1,), dtype=torch.int8, device=vals.device)
    return out.scatter_(-1, pos, vals)[..., :n]


def unpack_sparse_ac_np(deltas, vals, n: int) -> np.ndarray:
    """Host inverse of :func:`pack_sparse_ac` (tests/debug)."""
    pos = np.cumsum(np.asarray(deltas, np.int64)) - 1
    flat = np.zeros(n + 1, np.int8)
    keep = pos <= n
    flat[np.minimum(pos[keep], n)] = np.asarray(vals)[keep]
    return flat[:n]


# --- single-buffer batch wire (serving hot path) -----------------------------
#
# The staged dct420s batch is six arrays. The wire concatenates their raw
# bytes on the host, so a batch is one pinned buffer and one upload; the
# device inverse is slices + bitcast views (little-endian, as the numpy
# views of the host inverse).


def _wire_sections(n: int, bucket_h: int, bucket_w: int) -> list[int]:
    yb_h, yb_w = bucket_h // 8, bucket_w // 8
    cb_h, cb_w = bucket_h // 16, bucket_w // 16
    return [
        n * yb_h * yb_w * 2,      # y_dc int16
        n * cb_h * cb_w * 2 * 2,  # uv_dc int16 [n,cb_h,cb_w,2]
        n * 64 * 4,               # qy float32
        n * 64 * 4,               # qc float32
    ]


def wire_pack_dct420s(y_dc, uv_dc, qy, qc, deltas, vals) -> np.ndarray:
    """Staged dct420s batch arrays -> ONE contiguous uint8 upload buffer."""
    return np.concatenate(
        [
            np.ascontiguousarray(a).view(np.uint8).ravel()
            for a in (y_dc, uv_dc, qy, qc, deltas, vals)
        ]
    )


def _bitcast(section: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A uint8 run of the wire read as ``dtype``. A view when the run starts
    at a multiple of the element size (every section does on canvases
    bucketed to 256), else a copy of the run is viewed."""
    size = torch.empty((), dtype=dtype).element_size()
    if section.data_ptr() % size:
        section = section.clone()
    return section.view(dtype)


def wire_unpack_dct420s(wire: torch.Tensor, n: int, bucket_h: int, bucket_w: int):
    """Device inverse of :func:`wire_pack_dct420s`: typed views of the one
    uploaded uint8 buffer (the capacity follows from its length)."""
    yb_h, yb_w = bucket_h // 8, bucket_w // 8
    cb_h, cb_w = bucket_h // 16, bucket_w // 16
    sizes = _wire_sections(n, bucket_h, bucket_w)
    fixed = sum(sizes)
    cap = (wire.shape[0] - fixed) // (3 * n)  # deltas uint16 + vals int8
    o = np.cumsum([0] + sizes).tolist()
    y_dc = _bitcast(wire[o[0] : o[1]], torch.int16).reshape(n, yb_h, yb_w)
    uv_dc = _bitcast(wire[o[1] : o[2]], torch.int16).reshape(n, cb_h, cb_w, 2)
    qy = _bitcast(wire[o[2] : o[3]], torch.float32).reshape(n, 64)
    qc = _bitcast(wire[o[3] : o[4]], torch.float32).reshape(n, 64)
    deltas = _bitcast(wire[fixed : fixed + 2 * n * cap], torch.uint16).reshape(n, cap)
    vals = _bitcast(wire[fixed + 2 * n * cap :], torch.int8).reshape(n, cap)
    return y_dc, uv_dc, qy, qc, deltas, vals


def wire_unpack_dct420s_np(wire: np.ndarray, n: int, bucket_h: int, bucket_w: int):
    """Host inverse (numpy views, zero-copy): tests and stage profiling."""
    yb_h, yb_w = bucket_h // 8, bucket_w // 8
    cb_h, cb_w = bucket_h // 16, bucket_w // 16
    sizes = _wire_sections(n, bucket_h, bucket_w)
    fixed = sum(sizes)
    cap = (wire.shape[0] - fixed) // (3 * n)
    o = np.cumsum([0] + sizes)
    y_dc = wire[o[0] : o[1]].view(np.int16).reshape(n, yb_h, yb_w)
    uv_dc = wire[o[1] : o[2]].view(np.int16).reshape(n, cb_h, cb_w, 2)
    qy = wire[o[2] : o[3]].view(np.float32).reshape(n, 64)
    qc = wire[o[3] : o[4]].view(np.float32).reshape(n, 64)
    deltas = wire[fixed : fixed + 2 * n * cap].view(np.uint16).reshape(n, cap)
    vals = wire[fixed + 2 * n * cap :].view(np.int8).reshape(n, cap)
    return y_dc, uv_dc, qy, qc, deltas, vals


# --- native batch packer (serving hot path) ---------------------------------
#
# The numpy pack makes two index-materialising flatnonzero passes over the
# whole int8 batch, on the critical path of the stream's staging worker.
# native/sparse_pack.cpp replays the same semantics as one word-skipping
# scan with a thread per image slice.


def _load_pack_native():
    """The sparse packer's library with its signatures set, or None where
    ``g++`` is missing (the numpy path then serves, with identical output).
    Built without ``-march=native``: a build directory may travel to a host
    with another CPU."""
    lib = load_native("sparse_pack", flags=("-O3", "-pthread"))
    if lib is not None and lib.pack_sparse_ac_batch.argtypes is None:
        lib.sparse_count_entries_batch.argtypes = [
            ctypes.POINTER(ctypes.c_byte),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.sparse_count_entries_batch.restype = None
        lib.pack_sparse_ac_batch.argtypes = [
            ctypes.POINTER(ctypes.c_byte),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_ushort),
            ctypes.POINTER(ctypes.c_byte),
        ]
        lib.pack_sparse_ac_batch.restype = ctypes.c_int
    return lib


def pack_sparse_ac_batch(
    flat2d: np.ndarray, alloc=None
) -> tuple[np.ndarray, np.ndarray]:
    """Batch :func:`pack_sparse_ac` over ``flat2d [n_imgs, total]`` int8 with
    one shared capacity bucket (max entries across the batch). Native C++
    when available, numpy otherwise, with identical output.

    ``alloc(cap) -> (deltas [n,cap] uint16, vals [n,cap] int8)`` lets the
    caller provide the output arrays once the capacity is known: the wire
    staging path passes views into its single upload buffer so the pack
    writes directly to the wire (no concat copy). Both arrays are fully
    overwritten (tails zero-padded by the packer)."""
    flat2d = np.ascontiguousarray(flat2d, np.int8)
    n, total = flat2d.shape
    lib = _load_pack_native()
    if lib is None:
        nzs = [np.flatnonzero(flat2d[i]) for i in range(n)]
        cap = sparse_cap_bucket(
            max(sparse_nnz_entries(flat2d[i], nz=nzs[i]) for i in range(n)),
            total,
        )
        deltas, vals = alloc(cap) if alloc else (
            np.zeros((n, cap), np.uint16),
            np.zeros((n, cap), np.int8),
        )
        for i in range(n):
            deltas[i], vals[i] = pack_sparse_ac(flat2d[i], cap, nz=nzs[i])
        return deltas, vals
    entries = np.empty(n, np.int64)
    flat_ptr = flat2d.ctypes.data_as(ctypes.POINTER(ctypes.c_byte))
    lib.sparse_count_entries_batch(
        flat_ptr, n, total, entries.ctypes.data_as(ctypes.POINTER(ctypes.c_long))
    )
    cap = sparse_cap_bucket(int(entries.max()), total)
    deltas, vals = alloc(cap) if alloc else (
        np.empty((n, cap), np.uint16),
        np.empty((n, cap), np.int8),
    )
    ret = lib.pack_sparse_ac_batch(
        flat_ptr,
        n,
        total,
        cap,
        deltas.ctypes.data_as(ctypes.POINTER(ctypes.c_ushort)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
    )
    if ret != 0:  # cannot happen with a cap sized from the count pass
        raise RuntimeError("native sparse pack overflowed its capacity bucket")
    return deltas, vals


# --- sparse-bitmap FETCH wire (SR coefficient download) ---------------------
#
# The fetch direction packs on the DEVICE: a bit-pack and a rank scatter run
# beside the SR forward at device-memory speed, and the HOST pays the bitmap
# rank expansion, which is cheap for it.


def pack_sparse_bitmap_device(flat: torch.Tensor, cap: int):
    """Device pack for the FETCH direction (sparse download of
    device-encoded SR coefficients): flat int [n] (n % 8 == 0) ->
    (bitmap uint8 [n/8] big-endian bits, vals [cap] of flat's dtype,
    nnz int32 scalar tensor). When nnz > cap the overflow values are dropped
    into a dump slot, and nnz still counts them: callers MUST check it and
    fall back to a dense fetch rather than use truncated values.

    The scatter's writes collide only in the dump slot, so their order does
    not change the result. Ranks are int32: they count at most n."""
    mask = flat != 0
    ranks = torch.cumsum(mask, dim=0, dtype=torch.int32) - 1
    nnz = ranks[-1] + 1 if mask.shape[0] > 0 else torch.zeros((), dtype=torch.int32, device=flat.device)
    pos = torch.where(mask & (ranks < cap), ranks, torch.full_like(ranks, cap))  # cap = dump slot
    vals = torch.zeros(cap + 1, dtype=flat.dtype, device=flat.device).scatter_(0, pos.long(), flat)[:cap]
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=flat.device)
    bitmap = (mask.reshape(-1, 8).to(torch.int32) * weights).sum(dim=1)
    return bitmap.to(torch.uint8), vals, nnz.to(torch.int32)


def unpack_sparse_bitmap_np(bitmap, vals, n: int) -> np.ndarray:
    """Host inverse of the sparse-bitmap fetch wire -> flat [n] of vals'
    dtype (int8 compact wire or int16 wide wire)."""
    vals = _to_numpy(vals)
    bits = np.unpackbits(np.asarray(_to_numpy(bitmap), np.uint8))[:n].astype(bool)
    flat = np.zeros(n, vals.dtype)
    flat[bits] = vals[: int(bits.sum())]
    return flat
