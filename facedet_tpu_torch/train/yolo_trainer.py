"""YOLOv11 trainer and YOLO-format dataset loader.

Counterpart of facedet_tpu/train/yolo_trainer.py. ``YoloDataset`` is the
JAX class's numpy, copied: the same ``default_rng(seed)`` draws in the same
order give the same batches; ``jax.image.resize(..., "bilinear")``
(antialiased where it shrinks) is ops/image.resize_chw. ``YoloTrainer``
runs train/yolo_train.make_train_step with the reference's checkpoint
policy (best / last / every ``save_period`` epochs, patience) and writes its
checkpoints as flax ``.npz`` files (models/from_jax.to_jax_variables +
engine/detector.save_params_npz), which both packages load.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Iterator, Optional

import numpy as np
import torch

from facedet_tpu_torch.engine.detector import resolve_device, save_params_npz
from facedet_tpu_torch.models.from_jax import load_jax_variables, to_jax_variables
from facedet_tpu_torch.models.init import random_init
from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11
from facedet_tpu_torch.ops.image import resize_chw
from facedet_tpu_torch.train.yolo_train import make_optimizer, make_train_step

__all__ = ["YoloDataset", "YoloTrainer"]


def _resize_hwc(img: np.ndarray, size: int) -> np.ndarray:
    """``jax.image.resize(img, (size, size, 3), "bilinear")`` on the host."""
    chw = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)
    return resize_chw(chw, size, size, "bilinear").permute(1, 2, 0).numpy()


class YoloDataset:
    """images dir + YOLO labels dir -> static [B, S, S, 3] batches with padded
    GT ([B, M, 4] xyxy px + mask). Labels: 'cls cx cy w h' normalised."""

    def __init__(
        self,
        images_dir: str,
        labels_dir: str,
        image_size: int = 640,
        max_boxes: int = 64,
        augment: bool = False,
        seed: int = 0,
    ):
        self.images_dir = images_dir
        self.labels_dir = labels_dir
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        exts = (".jpg", ".jpeg", ".png", ".bmp")
        self.items = sorted(f for f in os.listdir(images_dir) if f.lower().endswith(exts))

    def __len__(self):
        return len(self.items)

    def _load(self, fname: str):
        from facedet_tpu_torch.utils.viz import load_image

        img = load_image(os.path.join(self.images_dir, fname)).astype(np.float32) / 255.0
        s = self.image_size
        # plain resize to square (trainer-side; letterbox kept for inference)
        imgr = _resize_hwc(img, s)
        label_path = os.path.join(self.labels_dir, os.path.splitext(fname)[0] + ".txt")
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        mask = np.zeros((self.max_boxes,), bool)
        if os.path.exists(label_path):
            with open(label_path) as f:
                rows = [ln.split() for ln in f if ln.strip()]
            for i, row in enumerate(rows[: self.max_boxes]):
                _, cx, cy, bw, bh = (float(v) for v in row[:5])
                boxes[i] = [(cx - bw / 2) * s, (cy - bh / 2) * s, (cx + bw / 2) * s, (cy + bh / 2) * s]
                mask[i] = True
        if self.augment and self.rng.random() < 0.5:  # fliplr (ref fliplr=0.5)
            imgr = imgr[:, ::-1].copy()
            x1 = boxes[:, 0].copy()
            boxes[:, 0] = s - boxes[:, 2]
            boxes[:, 2] = s - x1
        if self.augment:
            imgr = self._hsv_jitter(imgr)
        return imgr, boxes, mask

    def _hsv_jitter(self, img, h_gain=0.015, s_gain=0.7, v_gain=0.4):
        """Approximate HSV colour jitter: value scale, saturation blend toward
        gray, small hue rotation by channel mixing."""
        r = self.rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1.0
        out = img * r[2]
        gray = out.mean(-1, keepdims=True)
        out = gray + (out - gray) * r[1]
        out = out + (np.roll(out, 1, axis=-1) - out) * (r[0] - 1.0)
        return np.clip(out, 0, 1).astype(np.float32)

    def _mosaic(self, indices):
        """4-image mosaic: quadrants of a 2S canvas, rescaled to S, boxes
        remapped."""
        s = self.image_size
        canvas = np.zeros((2 * s, 2 * s, 3), np.float32)
        boxes_all = []
        for q, idx in enumerate(indices):
            img, boxes, mask = self._load(self.items[idx])
            oy, ox = (q // 2) * s, (q % 2) * s
            canvas[oy : oy + s, ox : ox + s] = img
            b = boxes.copy()
            b[:, [0, 2]] += ox
            b[:, [1, 3]] += oy
            boxes_all.append(b[mask])
        small = _resize_hwc(canvas, s)
        merged = np.concatenate(boxes_all, 0) / 2.0 if boxes_all else np.zeros((0, 4))
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        mask = np.zeros((self.max_boxes,), bool)
        n = min(len(merged), self.max_boxes)
        boxes[:n] = merged[:n]
        mask[:n] = True
        return small, boxes, mask

    def batches(self, batch_size: int, shuffle: bool = True, mosaic_prob: float = 0.5) -> Iterator[tuple]:
        """(images [B,S,S,3], boxes [B,M,4], mask [B,M], kpts [B,M,5,3]) CPU
        tensors; the remainder is dropped (static shapes)."""
        order = np.arange(len(self.items))
        if shuffle:
            self.rng.shuffle(order)

        def sample(i):
            if self.augment and len(self.items) >= 4 and self.rng.random() < mosaic_prob:
                idxs = [i] + list(self.rng.integers(0, len(self.items), 3))
                return self._mosaic(idxs)
            return self._load(self.items[i])

        for start in range(0, len(order) - batch_size + 1, batch_size):
            chunk = [sample(i) for i in order[start : start + batch_size]]
            imgs, boxes, masks = (np.stack([c[j] for c in chunk]) for j in range(3))
            kpts = np.zeros((batch_size, self.max_boxes, 5, 3), np.float32)
            yield tuple(torch.from_numpy(a) for a in (imgs, boxes, masks, kpts))


class YoloTrainer:
    """Explicit-training equivalent of the reference's ultralytics trainer.

    Weights: flax ``variables`` ({params, batch_stats}, numpy or a loaded
    ``.npz``) when given, else a seeded random init (models/init.py). The
    model trains on ``device`` (None: the card; raises without one unless
    ``device="cpu"``) in float32 parameters whatever ``cfg.dtype`` says."""

    def __init__(
        self,
        cfg: YoloConfig,
        lr: float = 1e-4,
        weight_decay: float = 5e-4,
        output_dir: str = "runs/yolo",
        patience: int = 10,
        save_period: int = 5,
        image_size: int = 640,
        seed: int = 0,
        device=None,
        variables: Optional[dict] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = YoloV11(cfg)
        if variables is None:
            random_init(model, seed)
        else:
            load_jax_variables(model, variables)
        self.model = model.to(self.device)
        self.tx = make_optimizer(self.model.parameters(), lr=lr, weight_decay=weight_decay)
        self.step_fn = make_train_step(self.model, self.tx)
        self.output_dir = output_dir
        self.patience = patience
        self.save_period = save_period
        self.image_size = image_size
        self.history: list[dict] = []
        self.best_loss = float("inf")
        self._stale = 0

    def save_checkpoint(self, name: str):
        """``output_dir/name.npz`` in flax's layout."""
        save_params_npz(os.path.join(self.output_dir, f"{name}.npz"), to_jax_variables(self.model.state_dict()))

    def fit(self, epoch_batches, num_epochs: int = 50, verbose: bool = True) -> dict:
        """``epoch_batches(epoch)`` yields (images, boxes, mask, kpts)."""
        for epoch in range(num_epochs):
            losses = []
            for images, boxes, mask, kpts in epoch_batches(epoch):
                loss, _parts = self.step_fn(images, boxes, mask, kpts)
                losses.append(float(loss))
            mean_loss = float(np.mean(losses)) if losses else 0.0
            self.history.append({"epoch": epoch, "train_loss": mean_loss})
            if verbose:
                print(f"epoch {epoch}: loss {mean_loss:.4f}")
            self.save_checkpoint("last")
            if self.save_period and (epoch + 1) % self.save_period == 0:
                self.save_checkpoint(f"epoch{epoch + 1}")
            if mean_loss < self.best_loss - 1e-6:
                self.best_loss = mean_loss
                self._stale = 0
                self.save_checkpoint("best")
            else:
                self._stale += 1
                if self._stale >= self.patience:
                    break
        os.makedirs(self.output_dir, exist_ok=True)
        with open(os.path.join(self.output_dir, "results.csv"), "w") as f:
            f.write("epoch,train_loss\n")
            for h in self.history:
                f.write(f"{h['epoch']},{h['train_loss']:.6f}\n")
        with open(os.path.join(self.output_dir, "config.json"), "w") as f:
            json.dump({"scale": self.cfg.scale, "imgsz": self.image_size, "epochs": len(self.history)}, f)
        return {"best_loss": self.best_loss, "epochs": len(self.history)}

    def as_detection_model(self, confidence_threshold: float = 0.25):
        """A ``YoloV11PoseDetectionModel`` on a copy of the current weights
        (cast to the config's dtype, eval mode), on the trainer's device."""
        from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel

        det = YoloV11PoseDetectionModel(
            scale=self.cfg.scale,
            dtype=self.cfg.dtype,
            bn_dtype=self.cfg.bn_dtype,
            confidence_threshold=confidence_threshold,
            image_size=self.image_size,
            load_at_init=False,
            device=self.device,
        )
        det.cfg = self.cfg
        det.model = copy.deepcopy(self.model).set_dtypes().eval()
        return det

    def validate(self, dataset, image_loader, use_sahi: bool = False) -> dict:
        """COCO mAP validation (tools/misc.validate_detector)."""
        from facedet_tpu_torch.tools.misc import validate_detector

        return validate_detector(self.as_detection_model(), dataset, image_loader, use_sahi=use_sahi)
