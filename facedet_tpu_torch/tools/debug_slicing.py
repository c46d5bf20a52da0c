"""Slicing-engine debug harness (counterpart of
facedet_tpu/tools/debug_slicing.py): slice one image, save every tile and
its per-tile detections, then run the whole slice-detect-merge and save
the merged result for a visual comparison.

    python -m facedet_tpu_torch.tools.debug_slicing --input photo.jpg \\
        --output debug_dir --family yolov11 --model-path weights.npz --scale n
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F


def debug_slicing(
    image: np.ndarray,
    detection_model,
    output_dir: str,
    slice_size: int = 640,
    overlap: float = 0.2,
) -> dict:
    from facedet_tpu_torch.engine.predict import get_sliced_prediction
    from facedet_tpu_torch.engine.prediction import detections_to_object_predictions
    from facedet_tpu_torch.ops.tiler import compute_slice_grid, gather_tiles
    from facedet_tpu_torch.utils.viz import draw_detections_on_image, save_image

    os.makedirs(output_dir, exist_ok=True)
    h, w = image.shape[:2]
    grid = compute_slice_grid(h, w, slice_size, slice_size, overlap, overlap)
    imgf = torch.from_numpy(np.asarray(image, np.float32) / 255.0).to(detection_model.device)
    padded = F.pad(imgf, (0, 0, 0, grid.padded_w - w, 0, grid.padded_h - h))
    offsets = torch.from_numpy(np.asarray(grid.offsets, np.int32)).to(detection_model.device)
    tiles = gather_tiles(padded, offsets, slice_size, slice_size)

    # save each tile and its per-tile detections
    per_tile = detection_model.forward_tiles(tiles)
    tiles8 = (tiles * 255).round().to(torch.uint8).cpu().numpy()
    tile_info = []
    for t in range(grid.num_tiles):
        save_image(os.path.join(output_dir, f"tile_{t:02d}.jpg"), tiles8[t])
        preds = detections_to_object_predictions(per_tile.map(lambda x: x[t]))  # noqa: B023
        save_image(
            os.path.join(output_dir, f"tile_{t:02d}_det.jpg"),
            draw_detections_on_image(tiles8[t], preds),
        )
        tile_info.append({"tile": t, "offset": grid.offsets[t].tolist(), "dets": len(preds)})

    # the whole merged pipeline
    result = get_sliced_prediction(
        image,
        detection_model,
        slice_height=slice_size,
        slice_width=slice_size,
        overlap_height_ratio=overlap,
        overlap_width_ratio=overlap,
        perform_standard_pred=False,
    )
    save_image(
        os.path.join(output_dir, "merged.jpg"),
        draw_detections_on_image(image, result.object_prediction_list),
    )
    return {
        "num_tiles": grid.num_tiles,
        "tiles": tile_info,
        "merged_detections": len(result.object_prediction_list),
    }


def main(argv=None):
    from facedet_tpu_torch.apps.common import base_parser, build_detector
    from facedet_tpu_torch.utils.config import DetectorConfig
    from facedet_tpu_torch.utils.viz import load_image

    ap = base_parser("Slicing debug harness: per-tile dumps + merged result")
    args = ap.parse_args(argv)
    model = build_detector(
        DetectorConfig(family=args.family, scale=args.scale, model_path=args.model_path,
                       confidence_threshold=args.conf, image_size=args.imgsz),
        device=args.device,
    )
    info = debug_slicing(load_image(args.input), model, args.output, args.slice, args.overlap)
    print(info)


if __name__ == "__main__":
    main()
