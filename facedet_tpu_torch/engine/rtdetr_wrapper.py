"""RT-DETR detection model wrapper and the ``FaceDetector`` facade
(counterpart of facedet_tpu/engine/rtdetr_wrapper.py).

The detector plugs into the same ``DetectionModel`` contract as YOLO and
SCRFD, so it composes with the sliced pipeline unchanged. As in the JAX
package, ``tile_forward`` scales both box axes by the tile **height**,
returns the raw top-k scores without NMS (set predictions) and zero
keypoints.

Two kinds of variant, by name: the presets of models/rtdetr.py
(``rtdetr-l``, ``rtdetr-m``, ``rtdetr-tiny``), which keep parity with the
JAX package's flax model and load its ``.npz`` trees; and the published
RT-DETR-l of models/rtdetr_l.py (``rtdetr-l-hgnetv2``, and its narrow
``rtdetr-l-hgnetv2-tiny``), which loads Ultralytics' own state-dict names
from an ``.npz`` or an exported ``model.state_dict()`` (``.pt`` / ``.pth``),
strictly (``rtdetr_l.load_state``). Without a path either is a seeded random
init.

On the card, in eval mode and with no capture under way, the whole chain
(forward, boxes to pixels, the sort and the validity mask) is replayed from
the detector's ``ForwardGraphs``, one CUDA graph per tile shape, inside a
``detector`` span that also counts ``deform_samples``: the bilinear samples
of the decoder's deformable attention in the call (tiles x queries x heads x
3 levels x points x layers, from the shapes on the host).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from facedet_tpu_torch.core.detections import Detections, take_rows
from facedet_tpu_torch.engine.detector import DetectionModel, _exact_float32, graph_key
from facedet_tpu_torch.models.rtdetr import RTDETR_VARIANTS, RtDetr, decode_rtdetr
from facedet_tpu_torch.models.rtdetr_l import NUM_LEVELS, RTDETR_L_VARIANTS, RtDetrL, load_state


class RtDetrDetectionModel(DetectionModel):
    def __init__(self, *args, variant: str = "rtdetr-l", dtype: str = "bfloat16", seed: int = 0, **kwargs):
        if variant not in RTDETR_VARIANTS and variant not in RTDETR_L_VARIANTS:
            raise ValueError(f"unknown RT-DETR variant {variant!r}; expected one of "
                             f"{sorted(RTDETR_VARIANTS) + sorted(RTDETR_L_VARIANTS)}")
        self.variant = variant
        self.dtype = dtype
        self.seed = seed
        super().__init__(*args, **kwargs)

    @property
    def published(self) -> bool:
        """The published RT-DETR-l layout (models/rtdetr_l.py)."""
        return self.variant in RTDETR_L_VARIANTS

    def load_model(self) -> None:
        self.model = self.float32_model().set_dtypes().to(self.device).eval()
        self.forward_graphs.clear()

    def float32_model(self):
        """The model as its checkpoint (or seed) gives it: float32 on the
        CPU, before ``set_dtypes``. models/quantize.py quantizes a bfloat16
        detector's kernels from it."""
        from facedet_tpu_torch.models.init import random_init

        variants = RTDETR_L_VARIANTS if self.published else RTDETR_VARIANTS
        self.cfg = dataclasses.replace(variants[self.variant], dtype=self.dtype,
                                       num_classes=len(self.category_mapping))
        model = (RtDetrL if self.published else RtDetr)(self.cfg)
        path = None if self.model_path is None else str(self.model_path)
        if path is None:
            random_init(model, self.seed)
        elif self.published and path.endswith(".npz"):
            with np.load(path) as flat:
                load_state(model, {k: flat[k] for k in flat.files})
        elif self.published and path.endswith((".pt", ".pth")):
            from facedet_tpu_torch.models.convert import _load_torch_state_dict

            load_state(model, _load_torch_state_dict(path))
        elif path.endswith(".npz"):
            from facedet_tpu_torch.models.from_jax import load_jax_variables, load_params_npz

            tree = load_params_npz(path)
            # checkpoints from before the denoising table existed lack
            # dn_embed; inference never reads it, so zeros of the right shape
            # stand in. A missing "params" fails here.
            params = tree["params"]
            if "dn_embed" not in params:
                params["dn_embed"] = np.zeros((self.cfg.num_classes + 1, self.cfg.hidden_dim), np.float32)
            load_jax_variables(model, tree)
        else:
            raise ValueError(f"unsupported checkpoint format: {self.model_path}")
        return model

    def deform_samples(self, tiles: int) -> int:
        """Bilinear samples the decoder takes for ``tiles`` tiles."""
        c = self.cfg
        return tiles * c.num_queries * c.num_heads * NUM_LEVELS * c.num_points * c.num_decoder_layers

    def tile_forward_nchw(self, tiles: torch.Tensor, conf_threshold: float) -> Detections:
        """The forward, the boxes in tile pixels, the top-k by a stable
        descending sort and the validity mask; no NMS. On the card, with the
        model in eval mode and no capture under way, replayed from
        ``forward_graphs``, one CUDA graph per ``graph_key``; elsewhere run
        eagerly."""

        def pre(x):
            preds = decode_rtdetr(self.model.forward_nchw(x), image_size=x.shape[2])
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

        key = None
        if tiles.is_cuda and not self.model.training and not torch.cuda.is_current_stream_capturing():
            key = graph_key(tiles, conf_threshold, self.max_detections_per_tile)
        with torch.inference_mode(), _exact_float32(self.dtype == "float32"):
            return self.forward_graphs(self.model, pre, tiles, key, lambda det: det.map(torch.clone),
                                       counts={"deform_samples": self.deform_samples(tiles.shape[0])})


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
