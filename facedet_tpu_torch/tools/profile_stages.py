"""Stage-level bisect of the sliced batch pipeline on the card.

Counterpart of facedet_tpu/tools/profile_stages.py. Each row runs a
truncated, scalar-reduced prefix of the port's own batch pipeline
(engine/predict.py: ``batch_core`` -> ``_pipeline``), built from the very
functions ``_pipeline`` calls, so a stage's cost is the difference between
consecutive rows. Every row is timed by ``utils.profiling.device_time``:
wall ms of single calls (CUDA events, no profiler), device ms and launches
from ``torch.profiler``, per image. The paths are host-bound, so the device
column carries the stage attribution and the wall column shows where the
host's time goes; in eager mode two consecutive wall rows can differ by less
than their noise.

The JAX tool's ``s2d_early`` branch is left out: the port has no
space-to-depth stack (models/yolov11.py). The ``tiles`` row and every row
after it launch the batched CHW gather (``facedet_tile_gather_chw_batched``).

Run on the card: python -m facedet_tpu_torch.tools.profile_stages
(``--device cpu`` runs it on the CPU, with no device numbers).
"""
from __future__ import annotations

import argparse

import torch

from facedet_tpu_torch.core.detections import Detections, concat_detections
from facedet_tpu_torch.utils.profiling import tree_sum

STAGES = [
    "unpack", "idct", "rgb", "tiles", "convs", "head_decode",
    "topk", "tile_nms", "standard", "truncate", "full",
]


def _decode_prefix(image, plan: dict, stage: str):
    """``decode_canvas``'s dct420s branch up to ``stage``: the canvas, or
    the stage's scalar."""
    from facedet_tpu_torch.ops.color import yuv420_to_rgb_chw
    from facedet_tpu_torch.ops.jpeg_dct import decode_dct420_to_yuv_f32, unpack_sparse_ac

    y_dc, uv_dc, qy, qc, deltas, vals = image
    yb_h, yb_w = plan["bucket_h"] // 8, plan["bucket_w"] // 8
    cb_h, cb_w = plan["bucket_h"] // 16, plan["bucket_w"] // 16
    ny = 64 * yb_h * yb_w
    flat = unpack_sparse_ac(deltas, vals, ny + 2 * 64 * cb_h * cb_w)
    if stage == "unpack":
        return tree_sum(flat)
    lead = flat.shape[:-1]
    y_ac = flat[..., :ny].reshape(*lead, 64, yb_h, yb_w).movedim(-3, -1)
    uv_ac = flat[..., ny:].reshape(*lead, 2, 64, cb_h, cb_w).movedim((-4, -3), (-2, -1))
    y, uv = decode_dct420_to_yuv_f32(y_dc, y_ac, uv_dc, uv_ac, qy, qc, out_dtype=plan["canvas_dtype"])
    if stage == "idct":
        return tree_sum((y, uv))
    canvas = yuv420_to_rgb_chw(y, uv, out_dtype=plan["canvas_dtype"])
    return tree_sum(canvas) if stage == "rgb" else canvas


def _chunk_prefix(model, plan: dict, image, consts, stage: str) -> torch.Tensor:
    """``_pipeline`` on one chunk of images, cut after ``stage``."""
    from facedet_tpu_torch.engine.predict import (
        _clip_detections,
        _shift_and_flatten,
        _truncate_by_score,
        letterbox_full,
    )
    from facedet_tpu_torch.models.yolo_decode import decode_predictions, decode_to_detections
    from facedet_tpu_torch.ops.kernels.tile_gather import gather_tiles_chw
    from facedet_tpu_torch.ops.nms import merge_detections

    offsets, tile_valid, true_hw = consts
    canvas = _decode_prefix(image, plan, stage)
    if stage in ("unpack", "idct", "rgb"):
        return canvas
    lead, t = canvas.shape[:-3], offsets.shape[0]
    tiles = gather_tiles_chw(canvas, offsets, plan["slice_height"], plan["slice_width"])
    if stage == "tiles":
        return tree_sum(tiles)
    outs = model.model.forward_nchw(tiles)
    if stage == "convs":
        return tree_sum(outs)
    preds = decode_predictions(outs)
    if stage == "head_decode":
        return tree_sum(preds)
    det = decode_to_detections(preds, conf_threshold=plan["conf"], max_detections=model.max_detections_per_tile,
                               nms_iou=0.7, class_agnostic=True, with_nms=stage != "topk")
    if stage in ("topk", "tile_nms"):
        return tree_sum(det)
    det = det.map(lambda x: x.reshape(*lead, t, *x.shape[1:]))
    parts = [_shift_and_flatten(det, offsets, tile_valid)]
    if plan["standard"]:
        full_tiles, scale = letterbox_full(canvas, true_hw, plan["img_size"])
        full = model.tile_forward_nchw(full_tiles.reshape(-1, *full_tiles.shape[-3:]), plan["conf"])
        full = full.map(lambda x: x.reshape(*lead, *x.shape[1:]))
        kpts = full.kpts.clone()
        kpts[..., :2] /= scale
        parts.append(Detections(full.boxes / scale, full.scores, full.classes, kpts, full.valid))
    if stage == "standard":  # the port's concat also truncates: the parts before it
        return tree_sum(parts)
    combined = concat_detections(parts, plan["merge_capacity"])
    if stage == "truncate":
        return tree_sum(combined)
    merged = merge_detections(
        combined,
        mode=plan["postprocess_type"],
        match_metric=plan["postprocess_match_metric"],
        match_threshold=plan["postprocess_match_threshold"],
        class_agnostic=plan["postprocess_class_agnostic"],
    )
    merged = _clip_detections(merged, plan["h"], plan["w"])
    fetch = plan["fetch_capacity"]
    if fetch and fetch < plan["merge_capacity"]:
        merged = _truncate_by_score(merged, fetch)
    return tree_sum(merged)


def build_stage_fn(model, plan: dict, stage: str, n_imgs: int):
    """The scalar-reduced prefix of ``batch_core`` up to ``stage`` for a
    ``dct420s`` batch of ``n_imgs`` images: ``f(wire, consts) -> scalar``,
    ``wire`` the uploaded uint8 buffer and ``consts`` (offsets, tile_valid,
    true_hw) on the model's device. Chunks of ``c`` images with ``c*T`` at
    most ``_MAX_FLAT_TILES``, as ``batch_core`` takes them."""
    from facedet_tpu_torch.engine.predict import _MAX_FLAT_TILES
    from facedet_tpu_torch.ops.jpeg_dct import wire_unpack_dct420s

    if plan["input_format"] != "dct420s":
        raise ValueError(f"profile_stages times the dct420s pipeline, not {plan['input_format']!r}")
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; expected one of {STAGES}")

    def batch_fn(wire, consts):
        image = wire_unpack_dct420s(wire, n_imgs, plan["bucket_h"], plan["bucket_w"])
        t = consts[0].shape[0]
        c = max(d for d in range(1, n_imgs + 1) if n_imgs % d == 0 and (d == 1 or d * t <= _MAX_FLAT_TILES))
        total = torch.zeros((), device=wire.device)
        for i in range(0, n_imgs, c):
            total = total + _chunk_prefix(model, plan, tuple(a[i : i + c] for a in image), consts, stage)
        return total

    return batch_fn


def stage_inputs(model, images, **sliced_kwargs):
    """(plan, wire on the model's device, consts) for a same-size batch of
    ``DctImage``s, as ``_dispatch_staged_batch`` builds them."""
    from facedet_tpu_torch.engine import predict as P

    opts = P._stream_opts({"input_format": "dct420s", **sliced_kwargs})
    plan = P._plan_sliced_batch(images, model, opts)
    staged = P._stage_batch_host(images, "dct420s", plan["bucket_h"], plan["bucket_w"])
    wire = P._to_device(staged, model.device)
    return plan, wire, P._resident_grid_consts(model, plan, model.device)


SERVING = dict(slice_height=640, slice_width=640, overlap_height_ratio=0.2, overlap_width_ratio=0.2,
               perform_standard_pred=True, postprocess_type="GREEDYNMM", postprocess_match_metric="IOS",
               postprocess_match_threshold=0.5, postprocess_class_agnostic=True, merge_capacity=1024)


def main(bsz: int = 8, device: str = "cuda", iters: int = 10, profile_iters: int = 3) -> dict:
    """yolo11s-pose (seeded), bfloat16, a batch of ``bsz`` 1024x1536
    ``dct420s`` images (quality 90), slice 640, the standard pass,
    GREEDYNMM/IOS 0.5: every stage's row per image. Returns
    ``{"rows": {stage: row}, "marginal": {stage: device ms (wall ms on the
    CPU)}}``."""
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel, _exact_float32, resolve_device
    from facedet_tpu_torch.engine.predict import _on_device
    from facedet_tpu_torch.ops.jpeg_dct import encode_dct420
    from facedet_tpu_torch.utils.profiling import device_time, format_row, marginal, per_unit
    from facedet_tpu_torch.utils.synth import bench_image

    dev = resolve_device(device)
    model = YoloV11PoseDetectionModel(scale="s", dtype="bfloat16", confidence_threshold=0.25, image_size=640,
                                      max_detections_per_tile=300, device=dev)
    planes = encode_dct420(bench_image(1024, 1536), quality=90)
    plan, wire, consts = stage_inputs(model, [planes] * bsz, **SERVING)
    rows = {}
    with torch.inference_mode(), _exact_float32(plan["canvas_dtype"] == torch.float32), _on_device(dev):
        for stage in STAGES:
            fn = build_stage_fn(model, plan, stage, bsz)
            rows[stage] = per_unit(device_time(fn, wire, consts, iters=iters, profile_iters=profile_iters), bsz)
            print(format_row(f"{stage} (cumulative)", rows[stage], "img"), flush=True)
    key, cost = marginal(rows)
    print(f"\n-- marginal cost per stage ({key.replace('_', ' ')} per image, difference of consecutive rows)")
    for stage, ms in cost.items():
        print(f"{stage:12s} {ms:8.3f}")
    return {"rows": rows, "marginal": cost}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bsz", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card; cpu runs without one)")
    args = ap.parse_args()
    main(bsz=args.bsz, device=args.device)
