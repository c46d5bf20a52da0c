"""A/B of the sparse-AC unpack's layout against the IDCT's, on the card.

Counterpart of facedet_tpu/tools/probe_unpack_fusion.py. The dct420s wire
is coefficient-major ([64, Hb, Wb] per plane), so the scatter fills
coefficient planes and the decode moves them into the IDCT product's
block-major [Hb, Wb, 64] layout. Variants, each decoding the luma planes of
a batch of one natural image's wire:

  current      the coefficient-major wire scattered (``unpack_sparse_ac``),
               then ``movedim`` to block-major, then ``_idct_plane``
  blockmajor   the same image packed in block-major order: the scatter lands
               in the product's layout and the reshape is free
  permscatter  the coefficient-major wire with each position mapped to its
               block-major slot at scatter time (no relayout pass)

Each gives the production coefficient planes exactly. The wire side, on
the host: the pack of each order, the bytes zlib leaves of each (a proxy of
how well a transfer compressor would do), and the copy of each from pinned
memory to the card. Each device row gives wall ms, device ms and launches
per image (``utils.profiling.device_time``).

``pack_order`` packs with the production packer (``pack_sparse_ac``): the
JAX probe's own pack wraps a gap over 65,535 in a uint16 and leaves the
wire's zero tail to overwrite the last value, and at its default size the
coefficient-major order has gaps of 239,989 (ROADMAP.md §3).

Run on the card: python -m facedet_tpu_torch.tools.probe_unpack_fusion
"""
from __future__ import annotations

import argparse
import time
import zlib

import numpy as np
import torch

from facedet_tpu_torch.ops.jpeg_dct import _as_unsigned16, _idct_plane, pack_sparse_ac, unpack_sparse_ac


def _natural_image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 210, (h // 32, w // 32, 3))
    img = np.kron(base, np.ones((32, 32, 1)))
    img = img + rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pack_order(flat: np.ndarray, cap: int):
    """Host pack of a flat int8 array in the order given: (deltas uint16
    [cap], vals int8 [cap], number of nonzeros). Where no gap between
    nonzeros exceeds 65,534 the first entries are the JAX probe's byte for
    byte; then one entry parks the position past them, and a longer gap is
    split by value-0 entries (``pack_sparse_ac``)."""
    nz = np.flatnonzero(flat)
    deltas, vals = pack_sparse_ac(flat, cap, nz)
    return deltas, vals, len(nz)


def flat_orders(d):
    """(coefficient-major, block-major) flat AC of a ``DctImage``: the
    wire's order and the IDCT's."""
    coef = np.concatenate([np.moveaxis(d.y_ac, -1, 0).reshape(-1), np.transpose(d.uv_ac, (2, 3, 0, 1)).reshape(-1)])
    block = np.concatenate([d.y_ac.reshape(-1), d.uv_ac.reshape(-1)])
    return coef, block


def _permuted_scatter(deltas, vals, n: int, hb: int, wb: int) -> torch.Tensor:
    """``unpack_sparse_ac`` with each luma position of the coefficient-major
    order moved to its block-major slot as it is written."""
    pos = torch.cumsum(_as_unsigned16(deltas), dim=-1, dtype=torch.int64) - 1
    pos = pos.clamp(max=n)
    ny = 64 * hb * wb
    k, blk = pos // (hb * wb), pos % (hb * wb)
    pos = torch.where(pos < ny, blk * 64 + k, pos)
    out = torch.zeros(deltas.shape[:-1] + (n + 1,), dtype=torch.int8, device=vals.device)
    return out.scatter_(-1, pos, vals)[..., :n]


def luma_planes(variant: str, deltas, vals, n: int, hb: int, wb: int) -> torch.Tensor:
    """The block-major luma AC planes [B, hb, wb, 64] a variant feeds the
    IDCT (``blockmajor`` takes the block-major wire, the others the
    coefficient-major one)."""
    ny = 64 * hb * wb
    if variant == "current":
        flat = unpack_sparse_ac(deltas, vals, n)
        return flat[..., :ny].reshape(-1, 64, hb, wb).movedim(1, -1)
    if variant == "blockmajor":
        return unpack_sparse_ac(deltas, vals, n)[..., :ny].reshape(-1, hb, wb, 64)
    if variant == "permscatter":
        return _permuted_scatter(deltas, vals, n, hb, wb)[..., :ny].reshape(-1, hb, wb, 64)
    raise ValueError(f"unknown variant {variant!r}")


VARIANTS = ("current", "blockmajor", "permscatter")


def main(h: int = 1024, w: int = 1536, batch: int = 8, device: str = "cuda", iters: int = 10,
         profile_iters: int = 3) -> dict:
    """Every variant on a batch of ``batch`` copies of one natural image's
    wire (quality 90). Returns ``{"rows": {variant: row per image},
    "planes_equal": {variant: bool}, "wire": {...}}``."""
    from facedet_tpu_torch.engine.detector import resolve_device
    from facedet_tpu_torch.ops.jpeg_dct import encode_dct420
    from facedet_tpu_torch.utils.profiling import device_time, format_row, per_unit

    dev = resolve_device(device)
    d = encode_dct420(_natural_image(h, w), quality=90)
    hb, wb = d.y_ac.shape[:2]
    flat_c, flat_b = flat_orders(d)
    n = flat_c.size
    cap = ((n // 4) + 7) & ~7
    packs, pack_ms = {}, {}
    for order, flat in (("coef", flat_c), ("block", flat_b)):
        t0 = time.perf_counter()
        packs[order] = pack_order(flat, cap)
        pack_ms[order] = (time.perf_counter() - t0) * 1e3
    print(f"planes: y_ac {d.y_ac.shape}, uv_ac {d.uv_ac.shape}, n={n}, nnz {packs['coef'][2]} "
          f"({100 * packs['coef'][2] / n:.1f}%), cap {cap}")
    up = lambda a: torch.from_numpy(np.stack([a] * batch)).to(dev)  # noqa: E731
    wires = {o: (up(p[0].view(np.int16)), up(p[1])) for o, p in packs.items()}
    dc = up(d.y_dc)
    q = torch.from_numpy(d.qy).to(dev)
    want = torch.from_numpy(d.y_ac).to(dev)
    rows, equal = {}, {}
    with torch.inference_mode():
        for variant in VARIANTS:
            deltas, vals = wires["block" if variant == "blockmajor" else "coef"]
            fn = lambda dd, vv, v=variant: _idct_plane(dc, luma_planes(v, dd, vv, n, hb, wb), q,  # noqa: E731
                                                       out_dtype=torch.bfloat16)
            rows[variant] = per_unit(device_time(fn, deltas, vals, iters=iters, profile_iters=profile_iters), batch)
            planes = luma_planes(variant, deltas, vals, n, hb, wb)
            equal[variant] = bool((planes == want).all())
            print(format_row(variant, rows[variant], "img") + f"  planes equal: {equal[variant]}", flush=True)
    wire = {"pack_ms": pack_ms,
            "zlib_bytes": {o: len(zlib.compress(np.concatenate([p[0].view(np.int8), p[1]]).tobytes(), 6))
                           for o, p in packs.items()},
            "upload_ms": _upload_ms(packs, dev)}
    print(f"host pack ms {wire['pack_ms']}, zlib bytes {wire['zlib_bytes']}, pinned upload of 64 wires ms "
          f"{wire['upload_ms']}")
    return {"rows": rows, "planes_equal": equal, "wire": wire}


def _upload_ms(packs: dict, dev: torch.device, rounds: int = 5):
    """Median ms of one copy of 64 tiled wires of each order from pinned
    memory to the card (None on the CPU: there is no copy to time)."""
    if dev.type != "cuda":
        return None
    out = {}
    for order, (deltas, vals, _) in packs.items():
        big = torch.from_numpy(np.tile(np.concatenate([deltas.view(np.int8), vals]), 64)).pin_memory()
        times = []
        for _ in range(rounds):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            big.to(dev, non_blocking=True)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        out[order] = float(np.median(times))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card; cpu runs without one)")
    main(device=ap.parse_args().device)
