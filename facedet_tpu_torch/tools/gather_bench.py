"""Time variants of the CHW tile gather on the card.

    python -m facedet_tpu_torch.tools.gather_bench [--baseline old_tile_gather.cu]

Builds ``csrc/tile_gather.cu`` once per variant of its three tuning macros
(threads of a band block, loads a thread starts before its stores, bytes a
band is sized to), checks each build bit for bit against the plain version,
and times it with CUDA events at the shapes the main paths use: the
production grid (3x1024x1536, 6 tiles of 640), the same batched at B=16, and
the enhance-first pipeline's grid (3x2048x3072, a 4x4 plan of 25 tiles of 512x768).
``--baseline`` adds another source with the same C interface (an earlier
revision of the kernel) to the same run, since two cards or two calls do not
compare. Prints one line per variant and shape, with the byte bound (the
union of the windows read once plus the tiles written once, at 3.35 TB/s).
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess

import numpy as np
import torch

from facedet_tpu_torch.ops import tiler
from facedet_tpu_torch.ops.kernels import build
from facedet_tpu_torch.ops.kernels.tile_gather import gather_tiles_chw_ref

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# (threads, unroll, band bytes); the first is the source's default
VARIANTS = [
    (128, 8, 10240), (128, 4, 10240), (128, 8, 5120), (128, 8, 20480), (256, 8, 20480),
    (256, 4, 10240), (256, 8, 40960), (512, 4, 40960), (128, 1, 1),
]


def compile_variant(source, tag: str, defines: dict) -> ctypes.CDLL:
    out = build.BUILD_DIR / "tune" / f"libtile_gather-{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f"-D{k}={v}" for k, v in defines.items()]
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(out), str(source)], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in build.SIGNATURES["tile_gather"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def run(lib, image, offsets, sh, sw):
    t = offsets.shape[0]
    c, h, w = image.shape[-3:]
    stream = torch.cuda.current_stream().cuda_stream
    if image.dim() == 3:
        out = torch.empty((t, c, sh, sw), dtype=image.dtype, device=image.device)
        rc = lib.facedet_tile_gather_chw(image.data_ptr(), offsets.data_ptr(), out.data_ptr(), t, c, h, w, sh, sw,
                                         image.element_size(), stream)
    else:
        b = image.shape[0]
        out = torch.empty((b * t, c, sh, sw), dtype=image.dtype, device=image.device)
        rc = lib.facedet_tile_gather_chw_batched(image.data_ptr(), offsets.data_ptr(), out.data_ptr(), b, t, c, h, w,
                                                 sh, sw, image.element_size(), stream)
    if rc:
        raise RuntimeError(f"launch failed: cudaError_t {rc}")
    return out


def event_ms(fn, reps=25) -> float:
    """Median device time of ``fn()``; the stream is held by a sleep kernel
    while the host enqueues, so the span between the events is device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def shapes(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def case(name, batch, h, w, sh, sw, ov, dtype):
        grid = tiler.compute_slice_grid(h, w, sh, sw, ov, ov)
        offs, _ = tiler.pad_grid_offsets(grid, tiler.bucket_tile_count(grid.num_tiles))
        shape = (3, h, w) if batch is None else (batch, 3, h, w)
        img = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8).to(dtype)
        covered = np.zeros((h, w), bool)
        for y, x in offs:
            covered[y : y + sh, x : x + sw] = True
        elem = img.element_size()
        nbytes = (batch or 1) * (int(covered.sum()) + len(offs) * sh * sw) * 3 * elem + offs.nbytes
        out[name] = (img, torch.from_numpy(offs).to(dev), sh, sw, nbytes / HBM_BYTES_PER_S * 1e3)

    case("production bfloat16", None, 1024, 1536, 640, 640, 0.2, torch.bfloat16)
    case("production float32", None, 1024, 1536, 640, 640, 0.2, torch.float32)
    case("production bfloat16 B=16", 16, 1024, 1536, 640, 640, 0.2, torch.bfloat16)
    sh, sw, ov = tiler.fixed_grid_slice_params(2048, 3072)
    case("enhance-first bfloat16", None, 2048, 3072, sh, sw, ov, torch.bfloat16)
    case("enhance-first float32", None, 2048, 3072, sh, sw, ov, torch.float32)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None, help="another .cu with the same C interface, timed beside the variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gather_bench: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = {}
    if args.baseline:
        libs["baseline"] = compile_variant(args.baseline, "baseline", {})
    src = build.CSRC / "tile_gather.cu"
    for threads, unroll, band in VARIANTS:
        tag = f"t{threads}-u{unroll}-b{band}"
        libs[tag] = compile_variant(src, tag, {
            "FACEDET_BAND_THREADS": threads, "FACEDET_BAND_UNROLL": unroll, "FACEDET_BAND_BYTES": band,
        })
    cases = shapes(dev)
    for name, (img, offs, sh, sw, bound_ms) in cases.items():
        want = gather_tiles_chw_ref(img, offs, sh, sw)
        for tag, lib in libs.items():
            got = run(lib, img, offs, sh, sw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"{tag} on {name}: differs from the plain version")
            del got
        # two rounds in opposite order, so that drift shows
        for order in (list(libs), list(libs)[::-1]):
            for tag in order:
                ms = event_ms(lambda: run(libs[tag], img, offs, sh, sw))  # noqa: B023
                print(f"{name}: {tag}: {ms:.5f} ms, bound {bound_ms:.5f} ms, {100 * bound_ms / ms:.1f}% of bound",
                      flush=True)
    print(smi)


if __name__ == "__main__":
    main()
