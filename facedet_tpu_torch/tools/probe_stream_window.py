"""A/B of ``predict_stream_batched``'s in-flight window (2, 3 and 4) in one
process, at the serving configuration, on the card.

Counterpart of facedet_tpu/tools/probe_stream_window.py: yolo11s-pose
(seeded), bfloat16, batches of 64 ``dct420s`` images of 1024x1536, slice
640, the standard pass, GREEDYNMM/IOS 0.5, ``fetch_capacity=300``, raw
results. The window keeps batches in flight between the staging worker, the
upload-and-dispatch worker and the caller's fetch; a deeper window helps
only if scheduling jitter, not a busy device, leaves the device idle between
batches. Three rounds; the order of the windows rotates each round, so that
no window always runs last. Images per second are host-clock throughput
over the whole stream (its copy streams and workers included), so there is
no device column here; the windows' results must be the same.

Run on the card: python -m facedet_tpu_torch.tools.probe_stream_window
"""
from __future__ import annotations

import argparse
import time

import torch

CFG = dict(
    slice_height=640, slice_width=640,
    overlap_height_ratio=0.2, overlap_width_ratio=0.2,
    perform_standard_pred=True, postprocess_type="GREEDYNMM",
    postprocess_match_metric="IOS", postprocess_match_threshold=0.5,
    postprocess_class_agnostic=True, input_format="dct420s",
    fetch_capacity=300,
)


def run_window(images: list, model, bsz: int, window: int, cfg: dict = CFG):
    """(raw batches on the host, seconds) of one stream over ``images``."""
    from facedet_tpu_torch.engine.predict import predict_stream_batched

    t0 = time.perf_counter()
    out = list(predict_stream_batched(images, model, batch_size=bsz, window=window, raw=True, **cfg))
    return out, time.perf_counter() - t0


def same_results(a: list, b: list) -> bool:
    """The two streams' raw batches are equal, field by field."""
    fields = ("boxes", "scores", "classes", "kpts", "valid")
    return len(a) == len(b) and all(torch.equal(getattr(x, f), getattr(y, f)) for x, y in zip(a, b) for f in fields)


def main(bsz: int = 64, batches: int = 5, image_hw=(1024, 1536), device: str = "cuda", rounds: int = 3) -> dict:
    """Returns ``{"images_per_s": {window: [per round]}, "same_results":
    bool}`` (every batch of every window's stream against the warm-up
    batch's, window 2)."""
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel, resolve_device
    from facedet_tpu_torch.ops.jpeg_dct import encode_dct420
    from facedet_tpu_torch.utils.synth import bench_image

    dev = resolve_device(device)
    model = YoloV11PoseDetectionModel(scale="s", dtype="bfloat16", confidence_threshold=0.25, image_size=640,
                                      max_detections_per_tile=300, device=dev)
    planes = encode_dct420(bench_image(*image_hw), quality=90)
    n = batches * bsz
    warm, _ = run_window([planes] * bsz, model, bsz, 2)  # one batch: every batch holds the same images
    windows = (2, 3, 4)
    rates = {w: [] for w in windows}
    same = True
    for r in range(rounds):
        for w in windows[r % 3:] + windows[: r % 3]:
            out, dt = run_window([planes] * n, model, bsz, w)
            done = sum(int(b.scores.shape[0]) for b in out)
            rates[w].append(done / dt)
            same &= same_results(out, warm * batches)
            print(f"round {r} window={w}: {done / dt:7.2f} img/s ({dt / batches:.3f} s/batch)", flush=True)
    print(f"the windows' results equal: {same}")
    return {"images_per_s": rates, "same_results": same}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card; cpu runs without one)")
    main(device=ap.parse_args().device)
