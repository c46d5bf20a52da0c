"""Bisect of the dct420s luma decode and two alternative formulations, on
the card.

Counterpart of facedet_tpu/tools/probe_idct_layout.py, over the port's
ops/jpeg_dct.py (``_idct_plane``, ``quality_tables``). Rows, on a seeded
batch of int16 DC and int8 AC planes:

  upcast       the int8 -> float32 upcast and the DC write only
  matmul       + the dequantising [N, 64] @ [64, 64] product
  current      + level shift, clip and the block-to-plane transpose:
               ``_idct_plane``, the production decode
  separable    the int8 coefficients relaid to strip layout first (a quarter
               of the float32 output's transpose bytes), then two separable
               8-point transforms along the plane's rows and columns
  bf16_matmul  the AC product in bfloat16 with the DC added exactly in
               float32 afterwards (a few gray levels of rounding)

The last two return the production plane (level-shifted and clipped);
``separable`` equals it within float32 rounding, ``bf16_matmul`` within
bfloat16's. Each row gives wall ms, device ms and launches per plane
(``utils.profiling.device_time``).

Run on the card: python -m facedet_tpu_torch.tools.probe_idct_layout
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from facedet_tpu_torch.ops.jpeg_dct import _C, _IDCT64, _idct_plane, quality_tables


def _coef(dc, ac):
    coef = ac.to(torch.float32, copy=True)
    coef[..., 0] = dc.to(torch.float32)
    return coef


def upcast(dc, ac, q):
    return _coef(dc, ac)


def matmul(dc, ac, q):
    b, hb, wb, _ = ac.shape
    basis = q[:, None] * torch.from_numpy(_IDCT64).to(q.device)
    return _coef(dc, ac).reshape(b, hb * wb, 64) @ basis


def current(dc, ac, q):
    return _idct_plane(dc, ac, q)


def separable(dc, ac, q):
    """Strip layout [B, hb, 8(j), wb, 8(k)] of the int8 coefficients, then
    C^T X C as two contractions of 8 along the full rows and columns."""
    b, hb, wb, _ = ac.shape
    c = torch.from_numpy(_C).to(ac.device)
    x = ac.reshape(b, hb, wb, 8, 8).permute(0, 1, 3, 2, 4)
    xf = x.to(torch.float32) * q.reshape(8, 8)[None, None, :, None, :]
    xf[:, :, 0, :, 0] = dc.to(torch.float32) * q[0]  # the DC plane replaces AC slot 0, as in _idct_plane
    y = torch.einsum("jr,bhjwk->bhrwk", c, xf)
    z = torch.einsum("kl,bhrwk->bhrwl", c, y)
    return (z.reshape(b, hb * 8, wb * 8) + 128.0).clamp(0.0, 255.0)


def bf16_matmul(dc, ac, q):
    """|ac * q| stays under about 3,800, where bfloat16's relative spacing
    of 2^-8 costs a gray level or a few after the 64-term sum; the DC term
    (a constant per block) goes in exactly in float32."""
    b, hb, wb, _ = ac.shape
    coef = ac.to(torch.bfloat16, copy=True)
    coef[..., 0] = 0
    basis = (q[:, None] * torch.from_numpy(_IDCT64).to(q.device)).to(torch.bfloat16)
    blocks = (coef.reshape(b, hb * wb, 64) @ basis).to(torch.float32).reshape(b, hb, wb, 8, 8)
    # the DC basis row is constant: C[0, i] * C[0, l] = 1/8
    blocks = blocks + (dc.to(torch.float32) * (q[0] / 8.0))[..., None, None]
    plane = blocks.permute(0, 1, 3, 2, 4).reshape(b, hb * 8, wb * 8) + 128.0
    return plane.clamp(0.0, 255.0)


VARIANTS = {"upcast": upcast, "matmul": matmul, "current": current, "separable": separable,
            "bf16_matmul": bf16_matmul}


def main(h: int = 1024, w: int = 1024, batch: int = 8, device: str = "cuda", iters: int = 10,
         profile_iters: int = 3) -> dict:
    """Every row on ``batch`` seeded luma planes of ``h`` x ``w`` at quality
    90. Returns ``{"rows": {variant: row per plane}, "max_abs_vs_current":
    {"separable": gray levels, "bf16_matmul": gray levels}}``."""
    from facedet_tpu_torch.engine.detector import resolve_device
    from facedet_tpu_torch.utils.profiling import device_time, format_row, per_unit

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    hb, wb = h // 8, w // 8
    dc = torch.from_numpy(rng.integers(-1000, 1000, (batch, hb, wb)).astype(np.int16)).to(dev)
    ac = torch.from_numpy(rng.integers(-30, 30, (batch, hb, wb, 64)).astype(np.int8)).to(dev)
    q = torch.from_numpy(quality_tables(90)[0]).to(dev)
    rows, diffs = {}, {}
    with torch.inference_mode():
        ref = current(dc, ac, q)
        for name, fn in VARIANTS.items():
            rows[name] = per_unit(device_time(fn, dc, ac, q, iters=iters, profile_iters=profile_iters), batch)
            extra = ""
            if name in ("separable", "bf16_matmul"):
                diffs[name] = float((fn(dc, ac, q) - ref).abs().max())
                extra = f"  max|d| vs current {diffs[name]:.4f} gray levels"
            print(format_row(name, rows[name], "plane") + extra, flush=True)
    return {"rows": rows, "max_abs_vs_current": diffs}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card; cpu runs without one)")
    main(device=ap.parse_args().device)
