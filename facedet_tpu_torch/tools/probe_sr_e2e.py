"""Stage split of the SR serving path (``FaceEnhancer.enhance_to_jpeg`` with
the sparse fetch), on the card.

Counterpart of facedet_tpu/tools/probe_sr_e2e.py. It times warm
``enhance_to_jpeg`` cycles end to end, then runs the same cycle split into
its stages, each waited for:

  load      file -> the bucket-padded image on the card (``_load_bucketed``)
  dispatch  the SR and JPEG-domain encode pipeline (``_enhance_dct_pipeline``)
            and the clip count read back (the device wait)
  fetch     the sparse planes copied to the host
  unpack    the host bitmap expansion (``unpack_sparse_bitmap_np``)
  wire      the planes -> ``DctImage`` (``wire_planes_to_dct_image``)
  write     the native entropy coder -> .jpg (``save_dct420_jpeg``; where it
            is not built, the host decode and a pixel JPEG, as
            ``enhance_to_jpeg`` does)

The staged cycle takes ``enhance_to_jpeg``'s branches (a density over the
sparse cap runs the cycle again with the dense fetch), writes the same bytes,
and its stages add up to the end-to-end cycle within 10% (``main`` reports
both, and the ratio of the two kinds of cycle over all turns).

Run on the card: python -m facedet_tpu_torch.tools.probe_sr_e2e [--scale 4] [--n 3]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

import numpy as np

STAGES = ("load", "dispatch", "fetch", "unpack", "wire", "write")


def staged_cycle(enh, src: str, dst: str, scale: float, quality: int, sparse: bool = True) -> tuple[dict, dict]:
    """One ``enhance_to_jpeg(src, dst, sparse=sparse)`` cycle split into
    ``STAGES``: ({stage: seconds}, info). It takes ``enhance_to_jpeg``'s
    branches: a sparse fetch whose density is over the cap runs the whole
    cycle again with the dense fetch (its seconds added to the first try's).
    Raises on clipped coefficients, which send the image to the pixel fetch."""
    import torch

    from facedet_tpu_torch.data.native_loader import save_dct420_jpeg
    from facedet_tpu_torch.ops.jpeg_dct import unpack_sparse_bitmap_np, wire_planes_to_dct_image

    sync = (lambda: torch.cuda.synchronize(enh.device)) if enh.device.type == "cuda" else (lambda: None)
    sec = dict.fromkeys(STAGES, 0.0)
    t = time.perf_counter()
    x, th_, tw_ = enh._load_bucketed(src)
    sync()
    sec["load"] = time.perf_counter() - t

    bh, bw = int(x.shape[0]), int(x.shape[1])
    pipeline, qy, qc, _ = enh._enhance_dct_pipeline(bh, bw, scale, quality, sparse=sparse)
    t = time.perf_counter()
    out = pipeline(x)
    n_clipped = int(out[-1])  # the device wait
    sec["dispatch"] = time.perf_counter() - t
    if n_clipped:
        raise RuntimeError(f"{n_clipped} clipped coefficients: the image takes the pixel fetch")

    t = time.perf_counter()
    fetched = [a.cpu().numpy() for a in out[:4]]
    info = {"sparse": sparse, "fetch_bytes": sum(a.nbytes for a in fetched)}
    if sparse:
        info.update(nnz=int(out[4]), cap=int(fetched[3].shape[0]))
    sec["fetch"] = time.perf_counter() - t
    if sparse and info["nnz"] > info["cap"]:
        dense_sec, dense_info = staged_cycle(enh, src, dst, scale, quality, sparse=False)
        return {k: sec[k] + dense_sec[k] for k in STAGES}, {**dense_info, "sparse_overflow": info}

    t = time.perf_counter()
    if sparse:
        y_dc, uv_dc, bitmap, vals = fetched
        yb_h, yb_w = y_dc.shape
        cb_h, cb_w = uv_dc.shape[:2]
        ny = 64 * yb_h * yb_w
        flat = unpack_sparse_bitmap_np(bitmap, vals, ny + 2 * 64 * cb_h * cb_w)
        planes = (y_dc, flat[:ny].reshape(64, yb_h, yb_w), uv_dc, flat[ny:].reshape(2, 64, cb_h, cb_w))
        info["density"] = info["nnz"] / flat.size
    else:
        planes = tuple(fetched)
    sec["unpack"] = time.perf_counter() - t

    t = time.perf_counter()
    d = wire_planes_to_dct_image(planes, qy, qc, (int(round(th_ * scale)), int(round(tw_ * scale))))
    sec["wire"] = time.perf_counter() - t

    t = time.perf_counter()
    info["native_write"] = save_dct420_jpeg(dst, d)
    if not info["native_write"]:
        from facedet_tpu_torch.engine.predict import _display_image
        from facedet_tpu_torch.utils.viz import save_image

        save_image(dst, _display_image(d), quality=quality)
    sec["write"] = time.perf_counter() - t
    return sec, info


def main(argv=None) -> dict:
    """Returns ``{"e2e_ms", "stages_ms": {stage: ms}, "sum_ms",
    "staged_over_e2e", "cycles_ms", "info", "same_bytes"}`` per image: the
    medians of ``--n`` cycles of each, run in turns; ``staged_over_e2e`` is
    the staged cycles' time over the end-to-end cycles' time, all turns
    summed, and ``cycles_ms`` holds each turn's two cycles."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", default="512,768")
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card; cpu runs without one)")
    args = ap.parse_args(argv)
    h, w = (int(v) for v in args.hw.split(","))

    from facedet_tpu_torch.engine.enhancer import FaceEnhancer
    from facedet_tpu_torch.utils.synth import bench_image
    from facedet_tpu_torch.utils.viz import save_image

    name = "RealESRGAN_x4plus" if args.scale == 4 else "RealESRGAN_x2plus"
    enh = FaceEnhancer(model_name=name, outscale=float(args.scale), tile=400, tile_pad=10, half=True,
                       device=args.device)
    with tempfile.TemporaryDirectory(prefix="probe_sr_e2e_") as tmp:
        src = os.path.join(tmp, "in.jpg")
        save_image(src, bench_image(h, w), quality=92)
        enh.enhance_to_jpeg(src, os.path.join(tmp, "warm.jpg"), quality=args.quality, sparse=True)
        # the end-to-end cycle and the staged one in turns, so that a drift of
        # the host's speed falls on both and each cycle follows one of the
        # other kind
        e2e, totals, stages, same = [], [], {k: [] for k in STAGES}, True
        for i in range(args.n):
            t0 = time.perf_counter()
            enh.enhance_to_jpeg(src, os.path.join(tmp, f"e{i}.jpg"), quality=args.quality, sparse=True)
            e2e.append(time.perf_counter() - t0)
            sec, info = staged_cycle(enh, src, os.path.join(tmp, f"s{i}.jpg"), float(args.scale), args.quality)
            for k, v in sec.items():
                stages[k].append(v)
            totals.append(sum(sec.values()))
            same &= Path(tmp, f"s{i}.jpg").read_bytes() == Path(tmp, f"e{i}.jpg").read_bytes()
    ratio = float(sum(totals) / sum(e2e))
    cycles = {"e2e": [round(v * 1e3, 1) for v in e2e], "staged": [round(v * 1e3, 1) for v in totals]}
    e2e = float(np.median(e2e))
    stages = {k: float(np.median(v)) for k, v in stages.items()}
    print(f"e2e enhance_to_jpeg: {e2e * 1e3:.1f} ms/img ({1.0 / e2e:.3f} img/s), branch "
          f"{enh.last_fetch.get('branch')}")
    print(f"  [{info}]")
    for k, v in stages.items():
        print(f"  {k:9s} {v * 1e3:8.1f} ms/img")
    total = sum(stages.values())
    print(f"  {'sum':9s} {total * 1e3:8.1f} ms/img  (e2e was {e2e * 1e3:.1f}); the same bytes: {same}")
    print(f"  staged over e2e, all turns: {ratio:.4f}  (ms per turn, e2e {cycles['e2e']}, "
          f"staged {cycles['staged']})")
    print(f"fetch bytes/img: {info['fetch_bytes'] / 1e6:.2f} MB")
    return {"e2e_ms": e2e * 1e3, "stages_ms": {k: v * 1e3 for k, v in stages.items()}, "sum_ms": total * 1e3,
            "staged_over_e2e": ratio, "cycles_ms": cycles, "info": info, "same_bytes": same}


if __name__ == "__main__":
    main()
