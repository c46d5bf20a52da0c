"""Probe: the upload of a dct420s batch as six arrays against one packed wire.

Counterpart of facedet_tpu/tools/probe_upload_pack.py. A batch of ``bsz``
copies of ``bench_image(h, w)``'s coefficient planes is staged by the
production ``engine/predict._stage_batch_host`` (dct420s, bucket 1024x1536,
as the JAX tool fixes it) and cut by ``wire_unpack_dct420s_np`` into its
six arrays (y_dc, uv_dc, qy, qc, deltas, vals). Three arms, each the median
of ``rounds`` runs after one warm-up:

  tuple of 6                  six uploads, one per array
  one wire incl. host concat  ``np.concatenate`` of the six, then one upload
  one wire upload only        one upload of the ready wire

An upload is ``torch.from_numpy(a).to(device)`` from pageable host memory,
as ``jnp.asarray`` uploads; then a small kernel reads 16 elements of each
array and ``.item()`` waits for it (the JAX tool's ``touch`` and ``sync``).
The port's serving path uploads one wire from pinned memory
(``engine/predict._StagingSlot``), which ``chip_smoke.py`` phase 8 times;
this probe adds no pinned arm. Times are the host's clock around the
upload and the wait: the question is the host's.

Run on the card: python -m facedet_tpu_torch.tools.probe_upload_pack
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

NAMES = ("y_dc", "uv_dc", "qy", "qc", "deltas", "vals")
BUCKET = (1024, 1536)  # the JAX tool's fixed bucket


def staged_arrays(bsz: int, h: int, w: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """(the production dct420s wire of ``bsz`` copies of ``bench_image(h,
    w)``, its six arrays as numpy views of it)."""
    from facedet_tpu_torch.engine.predict import _stage_batch_host
    from facedet_tpu_torch.ops.jpeg_dct import encode_dct420, wire_unpack_dct420s_np
    from facedet_tpu_torch.utils.synth import bench_image

    planes = encode_dct420(bench_image(h, w))
    wire = _stage_batch_host([planes] * bsz, "dct420s", *BUCKET)
    return wire, list(wire_unpack_dct420s_np(wire, bsz, *BUCKET))


def touch(xs) -> float:
    """Read 16 elements of each device array in one small sum and wait for it."""
    return float(sum(x.reshape(-1)[:16].to(torch.float32).sum() for x in xs).item())


def main(argv=None) -> dict:
    """Returns ``{"device", "memory": "pageable", "arrays": {name: [dtype,
    shape, bytes]}, "wire_bytes", "median_s": {arm: s}, "min_s": {arm: s},
    "readback_equal": {arm: bool}}``: each arm's last upload read back
    against the host's bytes."""
    from facedet_tpu_torch.engine.detector import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bsz", type=int, default=64)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--width", type=int, default=1536)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card; cpu runs without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    _, staged = staged_arrays(args.bsz, args.height, args.width)
    arrays = {}
    for nm, a in zip(NAMES, staged):
        arrays[nm] = [str(a.dtype), list(a.shape), int(a.nbytes)]
        print(f"{nm:8s} {a.dtype} {a.shape} {a.nbytes / 1e6:.2f} MB")
    print(f"total {sum(a.nbytes for a in staged) / 1e6:.2f} MB")
    wire = np.concatenate([np.ascontiguousarray(a).view(np.uint8).ravel() for a in staged])
    print(f"wire {wire.nbytes / 1e6:.2f} MB")

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    def t_tuple():
        t0 = time.perf_counter()
        devs = [up(a) for a in staged]
        touch(devs)
        return time.perf_counter() - t0, devs

    def t_wire_concat():
        t0 = time.perf_counter()
        w_ = np.concatenate([np.ascontiguousarray(a).view(np.uint8).ravel() for a in staged])
        devs = [up(w_)]
        touch(devs)
        return time.perf_counter() - t0, devs

    def t_wire_upload_only():
        t0 = time.perf_counter()
        devs = [up(wire)]
        touch(devs)
        return time.perf_counter() - t0, devs

    out = {"device": str(dev), "memory": "pageable", "arrays": arrays, "wire_bytes": int(wire.nbytes),
           "median_s": {}, "min_s": {}, "readback_equal": {}}
    for name, fn, host in (("tuple of 6 (current)", t_tuple, staged),
                           ("one wire incl. host concat", t_wire_concat, [wire]),
                           ("one wire upload only", t_wire_upload_only, [wire])):
        fn()  # warm
        runs = [fn() for _ in range(args.rounds)]
        ts = sorted(t for t, _ in runs)
        out["median_s"][name], out["min_s"][name] = ts[len(ts) // 2], ts[0]
        out["readback_equal"][name] = all(np.array_equal(d.cpu().numpy(), a) for d, a in zip(runs[-1][1], host))
        print(f"{name:28s} {ts[len(ts) // 2]:.6f} s/batch (min {ts[0]:.6f}) from pageable memory", flush=True)
    return out


if __name__ == "__main__":
    main()
