"""A/B of the SR tile plans at the serving shape, on the card.

Counterpart of facedet_tpu/tools/probe_sr_tiling.py: RealESRGAN_x4plus
(the committed golden weights), bfloat16, a 512x768 image, over three plans:

  legacy4x420  the fixed square grid: the image reflect-padded to 800x800
               and four 420x420 halo windows (tile 400, pad 10) in one batch
  planned      the port's tile plan (``engine.enhancer._tiled_sr_chw`` with
               ``plan_tile_grid``, tile 400, pad 10, 8 windows a call): what
               ``FaceEnhancer`` runs; it gathers its windows with the CHW
               tile-gather kernel when it cuts the image at all
  whole        one forward over the whole image, no halo, no padding

Each row gives wall ms, device ms and launches per image
(``utils.profiling.device_time``). The fidelity of the stitched plans
against the whole image: the largest and mean |diff| and the share of
values more than 1/255 apart (the seams' reflect padding only).

Run on the card: python -m facedet_tpu_torch.tools.probe_sr_tiling
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def legacy_square(enh, im: torch.Tensor, tile: int = 400, tile_pad: int = 10) -> torch.Tensor:
    """The fixed square grid on a CHW image: reflect-padded to whole tiles
    plus the halo, every window in one batch, the cores stitched."""
    from facedet_tpu_torch.ops.image import reflect_pad
    from facedet_tpu_torch.ops.kernels.tile_gather import gather_tiles_chw

    s = enh.cfg.scale
    h, w = im.shape[1], im.shape[2]
    gh, gw = -(-h // tile), -(-w // tile)
    ph, pw = gh * tile, gw * tile
    padded = reflect_pad(im, {1: (tile_pad, ph - h + tile_pad), 2: (tile_pad, pw - w + tile_pad)}).contiguous()
    win = tile + 2 * tile_pad
    tiles = gather_tiles_chw(padded, [(i * tile, j * tile) for i in range(gh) for j in range(gw)], win, win)
    out = enh._net(tiles)
    p = tile_pad * s
    core = out[:, :, p : p + tile * s, p : p + tile * s].reshape(gh, gw, 3, tile * s, tile * s)
    return core.permute(2, 0, 3, 1, 4).reshape(3, ph * s, pw * s)[:, : h * s, : w * s]


def plans(enh, tile: int = 400, tile_pad: int = 10, max_tiles_per_batch: int = 8) -> dict:
    """{plan: f(CHW float image on the enhancer's device) -> CHW output}."""
    from facedet_tpu_torch.engine.enhancer import _tiled_sr_chw

    s = enh.cfg.scale
    return {
        "legacy4x420": lambda im: legacy_square(enh, im, tile, tile_pad),
        "planned": lambda im: _tiled_sr_chw(enh._net, im, s, tile, tile_pad, max_tiles_per_batch),
        "whole": lambda im: enh._net(im[None])[0],
    }


def fidelity(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a.float() - b.float()).abs()
    return {"max": float(d.max()), "mean": float(d.mean()), "frac_over_1_255": float((d > 1 / 255).float().mean())}


def main(h: int = 512, w: int = 768, device: str = "cuda", iters: int = 3, profile_iters: int = 1) -> dict:
    """Returns ``{"rows": {plan: row per image}, "vs_whole": {plan:
    fidelity}}``."""
    from facedet_tpu_torch.engine.enhancer import FaceEnhancer
    from facedet_tpu_torch.utils.profiling import device_time, format_row

    enh = FaceEnhancer("RealESRGAN_x4plus", device=device)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 1, (3, h, w)).astype(np.float32)).to(enh.device)
    rows, outs = {}, {}
    with torch.inference_mode():
        for name, fn in plans(enh).items():
            rows[name] = device_time(fn, img, warmup=1, iters=iters, profile_iters=profile_iters)
            outs[name] = fn(img)
            print(format_row(name, rows[name], "img"), flush=True)
        vs_whole = {name: fidelity(outs[name], outs["whole"]) for name in ("legacy4x420", "planned")}
    for name, f in vs_whole.items():
        print(f"{name} against whole: max|diff| {f['max']:.4f}  mean {f['mean']:.6f}  "
              f"frac>1/255 {f['frac_over_1_255']:.4f}")
    return {"rows": rows, "vs_whole": vs_whole}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card; cpu runs without one)")
    main(device=ap.parse_args().device)
