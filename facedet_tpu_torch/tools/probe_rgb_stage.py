"""A/B of the YUV->RGB canvas stage's formulations on the card.

Counterpart of facedet_tpu/tools/probe_rgb_stage.py, on a bfloat16 batch of
Y and UV planes (the serving canvas dtype). Variants, each returning the
CHW canvas [B, 3, H, W] in [0, 1]:

  current      ops/color.yuv420_to_rgb_chw (bilinear 2x chroma upsample, the
               [3, 3] @ [3, H*W] product, the [0, 1] clip): the production
  planar_fma   the same upsample, the BT.601 mix written as per-plane
               multiply-adds with the production matrix's coefficients
  fma_noclip   planar_fma without the final clip: NOT fidelity-equivalent
               for out-of-gamut pixels (it measures the clip's cost)
  nearest_fma  planar FMA with nearest (repeat) chroma doubling instead of
               bilinear: fidelity-changing, measurement only

Each row gives wall ms, device ms and launches per image
(``utils.profiling.device_time``).

Run on the card: python -m facedet_tpu_torch.tools.probe_rgb_stage
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from facedet_tpu_torch.ops.color import _INV, _up2x_axis, yuv420_to_rgb_chw

FIDELITY_CHANGING = ("fma_noclip", "nearest_fma")


def _mix_fma(yf, cb, cr):
    # BT.601 coefficients taken from the production matrix, so the FMA
    # variants cannot drift from ops/color's conversion
    r = yf + float(_INV[0, 2]) * cr
    g = yf + float(_INV[1, 1]) * cb + float(_INV[1, 2]) * cr
    b = yf + float(_INV[2, 1]) * cb
    return torch.stack([r, g, b], dim=-3)


def _planar(y, uv, dt, upsample, clip=True):
    up = upsample(uv.to(dt).movedim(-1, -3)) - 128.0  # [..., 2, H, W]
    rgb = _mix_fma(y.to(dt), up[..., 0, :, :], up[..., 1, :, :]) / 255.0
    return rgb.clamp(0.0, 1.0) if clip else rgb


def _bilinear(uv):
    return _up2x_axis(_up2x_axis(uv, -2), -1)


def _nearest(uv):
    return uv.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


VARIANTS = {
    "current": lambda y, uv, dt: yuv420_to_rgb_chw(y, uv, out_dtype=dt),
    "planar_fma": lambda y, uv, dt: _planar(y, uv, dt, _bilinear),
    "fma_noclip": lambda y, uv, dt: _planar(y, uv, dt, _bilinear, clip=False),
    "nearest_fma": lambda y, uv, dt: _planar(y, uv, dt, _nearest),
}


def main(h: int = 1024, w: int = 1536, batch: int = 8, dt=torch.bfloat16, device: str = "cuda",
         iters: int = 10, profile_iters: int = 3) -> dict:
    """Every variant on a seeded batch of ``batch`` Y [h, w] and UV [h/2,
    w/2, 2] planes in ``dt``. Returns ``{"rows": {variant: row per image},
    "max_abs_vs_current": {variant: float}}``."""
    from facedet_tpu_torch.engine.detector import resolve_device
    from facedet_tpu_torch.utils.profiling import device_time, format_row, per_unit

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.integers(0, 256, (batch, h, w)).astype(np.float32)).to(dev, dt)
    uv = torch.from_numpy(rng.integers(0, 256, (batch, h // 2, w // 2, 2)).astype(np.float32)).to(dev, dt)
    rows, diffs = {}, {}
    with torch.inference_mode():
        ref = VARIANTS["current"](y, uv, dt).float()
        for name, fn in VARIANTS.items():
            rows[name] = per_unit(device_time(fn, y, uv, dt, iters=iters, profile_iters=profile_iters), batch)
            diffs[name] = float((fn(y, uv, dt).float() - ref).abs().max())
            tag = " (fidelity-changing)" if name in FIDELITY_CHANGING else ""
            print(format_row(name, rows[name], "img") + f"  max|d| vs current {diffs[name]:.4f}{tag}", flush=True)
    return {"rows": rows, "max_abs_vs_current": diffs}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card; cpu runs without one)")
    main(device=ap.parse_args().device)
