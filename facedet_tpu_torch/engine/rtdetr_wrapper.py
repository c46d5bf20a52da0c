"""RT-DETR detection model wrapper and the ``FaceDetector`` facade
(counterpart of facedet_tpu/engine/rtdetr_wrapper.py).

The detector plugs into the same ``DetectionModel`` contract as YOLO and
SCRFD, so it composes with the sliced pipeline unchanged. As in the JAX
package, ``tile_forward`` scales both box axes by the tile **height**,
returns the raw top-k scores without NMS (set predictions) and zero
keypoints.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from facedet_tpu_torch.core.detections import Detections, take_rows
from facedet_tpu_torch.engine.detector import DetectionModel, _exact_float32
from facedet_tpu_torch.models.rtdetr import RTDETR_VARIANTS, RtDetr, decode_rtdetr


class RtDetrDetectionModel(DetectionModel):
    def __init__(self, *args, variant: str = "rtdetr-l", dtype: str = "bfloat16", seed: int = 0, **kwargs):
        self.variant = variant
        self.dtype = dtype
        self.seed = seed
        super().__init__(*args, **kwargs)

    def load_model(self) -> None:
        from facedet_tpu_torch.models.from_jax import load_jax_variables, load_params_npz
        from facedet_tpu_torch.models.init import random_init

        cfg = RTDETR_VARIANTS[self.variant]
        self.cfg = dataclasses.replace(cfg, dtype=self.dtype, num_classes=len(self.category_mapping))
        model = RtDetr(self.cfg)
        if self.model_path is None:
            random_init(model, self.seed)
        elif str(self.model_path).endswith(".npz"):
            tree = load_params_npz(self.model_path)
            # checkpoints from before the denoising table existed lack
            # dn_embed; inference never reads it, so zeros of the right shape
            # stand in. A missing "params" fails here.
            params = tree["params"]
            if "dn_embed" not in params:
                params["dn_embed"] = np.zeros((self.cfg.num_classes + 1, self.cfg.hidden_dim), np.float32)
            load_jax_variables(model, tree)
        else:
            raise ValueError(f"unsupported checkpoint format: {self.model_path}")
        self.model = model.set_dtypes().to(self.device).eval()

    def tile_forward_nchw(self, tiles: torch.Tensor, conf_threshold: float) -> Detections:
        with torch.inference_mode(), _exact_float32(self.dtype == "float32"):
            outs = self.model.forward_nchw(tiles)
            preds = decode_rtdetr(outs, image_size=tiles.shape[2])
            # DETR: set predictions, no NMS; top-k by score with a validity
            # mask. A stable descending sort breaks ties toward the lower
            # index, as lax.top_k does.
            boxes, scores = preds["boxes"], preds["scores"]
            best, cls = scores.max(dim=-1)
            k = min(self.max_detections_per_tile, boxes.shape[1])
            top_val, top_idx = torch.sort(best, dim=1, descending=True, stable=True)
            top_val, top_idx = top_val[:, :k], top_idx[:, :k]
            return Detections(
                boxes=take_rows(boxes, top_idx),
                scores=top_val,
                classes=take_rows(cls, top_idx).to(torch.int32),
                kpts=torch.zeros((boxes.shape[0], k, 5, 3), dtype=torch.float32, device=boxes.device),
                valid=top_val >= conf_threshold,
            )


class FaceDetector:
    """Inference facade over an RT-DETR checkpoint (reference
    pipeline_v3_RTDETR/inference.py:12): image, folder, video and webcam
    modes."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        variant: str = "rtdetr-l",
        conf: float = 0.5,
        image_size: int = 640,
        device=None,
    ):
        self.model = RtDetrDetectionModel(
            model_path=model_path,
            variant=variant,
            confidence_threshold=conf,
            image_size=image_size,
            device=device,
        )

    def detect_image(self, image_path: str, output_path: Optional[str] = None):
        from facedet_tpu_torch.engine.predict import get_prediction
        from facedet_tpu_torch.utils.viz import draw_detections_on_image, load_image, save_image

        image = load_image(image_path)
        result = get_prediction(image, self.model)
        if output_path:
            save_image(output_path, draw_detections_on_image(image, result.object_prediction_list))
        return result

    def detect_folder(self, input_dir: str, output_dir: str) -> list:
        os.makedirs(output_dir, exist_ok=True)
        results = []
        for fname in sorted(os.listdir(input_dir)):
            if not fname.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                continue
            results.append(self.detect_image(os.path.join(input_dir, fname), os.path.join(output_dir, fname)))
        return results

    def detect_video(self, video_path: str, output_path: str, frame_skip: int = 0, verbose: bool = True) -> dict:
        """Per-frame detection over a video, writing an annotated MJPEG AVI
        (reference inference.py:60-116 through cv2; here data/video.py
        decodes MJPEG-AVI and Y4M itself and anything else through an ffmpeg
        subprocess where one exists). Frames stream through
        ``predict_stream``, so decode, upload and compute overlap."""
        import time

        from facedet_tpu_torch.data.video import MjpegAviWriter, read_video_frames, video_info
        from facedet_tpu_torch.engine.predict import predict_stream
        from facedet_tpu_torch.utils.viz import draw_detections_on_image

        info = video_info(video_path)
        fps = float(info.get("fps") or 25.0)

        def frames():
            for i, frame in enumerate(read_video_frames(video_path)):
                if frame_skip and i % (frame_skip + 1):
                    continue
                yield frame

        writer = MjpegAviWriter(output_path, fps=fps / (frame_skip + 1))
        n = 0
        total_faces = 0
        t0 = time.perf_counter()
        # with-block: an error mid-video must not orphan the writer's spool
        # file on disk (gigabytes for a long video)
        with writer:
            for result in predict_stream(frames(), self.model, perform_standard_pred=True):
                writer.write(draw_detections_on_image(result.image, result.object_prediction_list))
                total_faces += len(result.object_prediction_list)
                n += 1
                if verbose and n % 25 == 0:
                    print(f"frame {n}: {len(result.object_prediction_list)} faces")
        dt = time.perf_counter() - t0
        if verbose:
            print(f"{n} frames, {total_faces} faces in {dt:.1f}s -> {output_path}")
        return {"frames": n, "faces": total_faces, "seconds": dt}

    def detect_webcam(self, device: str = "/dev/video0", max_frames: int = 0):
        """Webcam mode (reference inference.py:118-163): a generator of each
        live frame's ``PredictionResult``, read from the camera through
        ``ffmpeg -f v4l2`` (its size from ffprobe). Without an ffmpeg binary
        or a camera at ``device`` it raises ``RuntimeError`` when iterated."""
        import subprocess

        from facedet_tpu_torch.data.video import ffmpeg_available
        from facedet_tpu_torch.engine.predict import predict_stream

        if not (ffmpeg_available() and os.path.exists(device)):
            raise RuntimeError(
                f"webcam mode needs an ffmpeg binary and a camera at {device}; "
                "use detect_video on a file"
            )
        probe = subprocess.run(
            ["ffprobe", "-v", "error", "-f", "v4l2", "-select_streams", "v:0",
             "-show_entries", "stream=width,height", "-of", "csv=p=0", device],
            capture_output=True, text=True, check=True,
        ).stdout.strip().split(",")
        w, h = int(probe[0]), int(probe[1])
        proc = subprocess.Popen(
            ["ffmpeg", "-v", "error", "-f", "v4l2", "-i", device,
             "-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
            stdout=subprocess.PIPE,
        )

        def frames():
            i = 0
            while not max_frames or i < max_frames:
                raw = proc.stdout.read(w * h * 3)
                if len(raw) < w * h * 3:
                    return
                yield np.frombuffer(raw, np.uint8).reshape(h, w, 3).copy()
                i += 1

        try:
            yield from predict_stream(frames(), self.model, perform_standard_pred=True)
        finally:
            proc.terminate()
