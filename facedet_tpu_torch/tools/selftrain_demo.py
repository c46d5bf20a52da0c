"""Self-contained learning proof: train yolo11n-pose (or SCRFD) from a seeded
random init on synthetic face-like blobs and show COCO mAP going from about
0 to high.

Counterpart of facedet_tpu/tools/selftrain_demo.py: the same blob dataset
(``make_blob_dataset``, copied), the same optimizer settings (lr 2e-3,
warmup 20), batches drawn by ``default_rng(1)``, validation through the
port's detector and ``get_prediction``. It needs no dataset and no
pretrained weights: it is the evidence that the training stack (TAL
assigner, DFL / IoU / cls losses, optimizer, decode, NMS, COCO scorer)
learns. ``--model rtdetr`` trains ``--variant`` (rtdetr-tiny) with
``--dn-groups`` (5) contrastive-denoising groups: lr 4e-4 unless given,
warmup ``min(100, steps // 10)`` then cosine to 0.05 lr, clip 0.1 and AdamW
(weight decay 1e-4), validated at confidence 0.05.

Run: python -m facedet_tpu_torch.tools.selftrain_demo [--steps 300] [--model yolo|scrfd|rtdetr] [--kpts]
(on the CUDA device; ``--device cpu`` runs it on the CPU).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import time

import numpy as np
import torch

# fractional landmark offsets inside a blob of radius r, centered at (cx, cy):
# [left_eye, right_eye, nose, left_mouth, right_mouth] x (dx/r, dy/r)
_KPT_OFFSETS = np.array(
    [[-0.45, -0.35], [0.45, -0.35], [0.0, 0.1], [-0.4, 0.55], [0.4, 0.55]],
    np.float32,
)


def make_blob_dataset(n_images: int, size: int = 96, max_boxes: int = 4, seed: int = 0,
                      with_kpts: bool = False):
    """Bright ellipse 'faces' on dark textured background + exact GT boxes.

    ``with_kpts=True`` additionally stamps 5 dark landmark dots per face at
    fixed fractional offsets (eyes/nose/mouth layout) and returns their exact
    positions."""
    rng = np.random.default_rng(seed)
    images = np.zeros((n_images, size, size, 3), np.float32)
    boxes = np.zeros((n_images, max_boxes, 4), np.float32)
    masks = np.zeros((n_images, max_boxes), bool)
    kpts = np.zeros((n_images, max_boxes, 5, 3), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n_images):
        img = rng.uniform(0.0, 0.25, (size, size, 3)).astype(np.float32)
        k = int(rng.integers(1, max_boxes))
        for j in range(k):
            r = int(rng.integers(8, 16))
            cy = int(rng.integers(r + 2, size - r - 2))
            cx = int(rng.integers(r + 2, size - r - 2))
            m = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r
            color = rng.uniform(0.7, 1.0, 3)
            img[m] = color
            boxes[i, j] = [cx - r, cy - r, cx + r, cy + r]
            masks[i, j] = True
            if with_kpts:
                pts = np.array([cx, cy], np.float32) + _KPT_OFFSETS * r
                dot_r2 = max(1.0, r / 6.0) ** 2
                for (px, py), shade in zip(
                    pts, ([0.1, 0.1, 0.4], [0.1, 0.4, 0.1], [0.4, 0.1, 0.1],
                          [0.35, 0.35, 0.05], [0.35, 0.05, 0.35])
                ):
                    dm = ((yy - py) ** 2 + (xx - px) ** 2) <= dot_r2
                    img[dm] = shade
                kpts[i, j, :, :2] = pts
                kpts[i, j, :, 2] = 1.0
        images[i] = img
    if with_kpts:
        return images, boxes, masks, kpts
    return images, boxes, masks


def _kpt_pixel_error(det_model, val_images, val_boxes, val_masks, val_kpts):
    """Mean landmark pixel error over val faces whose box is recovered
    (IoU > 0.5 best match), and the match count."""
    from facedet_tpu_torch.core.boxes import iou_matrix

    errs = []
    for i in range(len(val_images)):
        det_model.perform_inference((val_images[i] * 255).astype(np.uint8))
        det_model.convert_original_predictions()
        preds = det_model.object_prediction_list
        gt_b = val_boxes[i][val_masks[i]]
        gt_k = val_kpts[i][val_masks[i]]
        if not len(preds) or not len(gt_b):
            continue
        p_b = np.array([p.bbox.to_xyxy() for p in preds], np.float32)
        iou = iou_matrix(torch.from_numpy(gt_b), torch.from_numpy(p_b)).numpy()
        for g in range(len(gt_b)):
            p = int(np.argmax(iou[g]))
            if iou[g, p] < 0.5 or preds[p].keypoints is None:
                continue
            pk = np.asarray(preds[p].keypoints, np.float32).reshape(-1, 3)
            d = np.linalg.norm(pk[:, :2] - gt_k[g][:, :2], axis=1)
            errs.append(float(d.mean()))
    return (float(np.mean(errs)) if errs else None), len(errs)


def _yolo(args, device):
    """(model, make-step function, detector function) for yolo11n-pose."""
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
    from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11
    from facedet_tpu_torch.train.yolo_train import make_train_step

    cfg = YoloConfig(scale="n", num_classes=1, with_pose=True)

    def detector(model):
        det = YoloV11PoseDetectionModel(scale="n", dtype="float32", confidence_threshold=0.25,
                                        image_size=args.size, load_at_init=False, device=device)
        det.cfg = cfg
        det.model = copy.deepcopy(model).eval()
        return det

    return YoloV11(cfg), make_train_step, detector


def _scrfd(args, device):
    """(model, make-step function, detector function) for SCRFD (``--variant``,
    else scrfd_500m), float32."""
    from facedet_tpu_torch.engine.scrfd_wrapper import ScrfdDetectionModel
    from facedet_tpu_torch.models.scrfd import SCRFD_VARIANTS, Scrfd
    from facedet_tpu_torch.train.scrfd_train import make_scrfd_train_step

    variant = args.variant if args.variant in SCRFD_VARIANTS else "scrfd_500m"
    cfg = dataclasses.replace(SCRFD_VARIANTS[variant], dtype="float32")

    def detector(model):
        det = ScrfdDetectionModel(variant=variant, dtype="float32", confidence_threshold=0.25,
                                  image_size=args.size, load_at_init=False, device=device)
        det.cfg = cfg
        det._onnx = None
        det.model = copy.deepcopy(model).eval()
        return det

    return Scrfd(cfg), make_scrfd_train_step, detector


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--model", choices=("yolo", "rtdetr", "scrfd"), default="yolo")
    ap.add_argument("--dn-groups", type=int, default=5, help="rtdetr contrastive-denoising groups (0 = off)")
    ap.add_argument("--variant", default=None,
                    help="SCRFD_VARIANTS key for --model scrfd (scrfd_500m), RTDETR_VARIANTS key for --model "
                    "rtdetr (rtdetr-tiny)")
    ap.add_argument("--kpts", action="store_true",
                    help="stamp synthetic 5-landmark dots on the blobs, train with keypoint "
                    "supervision, and report landmark pixel error before/after")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from facedet_tpu_torch.engine.detector import resolve_device
    from facedet_tpu_torch.models.init import random_init
    from facedet_tpu_torch.tools.misc import validate_detector
    from facedet_tpu_torch.train.yolo_train import make_optimizer

    device = resolve_device(args.device)
    if args.kpts:
        images, boxes, masks, gt_kpts = make_blob_dataset(64, args.size, with_kpts=True)
        val_images, val_boxes, val_masks, val_kpts = make_blob_dataset(16, args.size, seed=99, with_kpts=True)
    else:
        images, boxes, masks = make_blob_dataset(64, args.size)
        val_images, val_boxes, val_masks = make_blob_dataset(16, args.size, seed=99)
        gt_kpts = np.zeros(boxes.shape[:2] + (5, 3), np.float32)
        val_kpts = None
    val_dataset = [
        {
            "image_id": i,
            "file_name": f"val_{i}",
            "gt": [[b[0], b[1], b[2] - b[0], b[3] - b[1]] for b, m in zip(val_boxes[i], val_masks[i]) if m],
        }
        for i in range(len(val_images))
    ]
    val_loader = lambda name: val_images[int(name.split("_")[1])]  # noqa: E731
    if args.model == "rtdetr":
        return _main_rtdetr(args, device, (images, boxes, masks), val_dataset, val_loader)

    model, make_step, detector = (_yolo if args.model == "yolo" else _scrfd)(args, device)
    random_init(model, 0)
    model.to(device)
    tx = make_optimizer(model.parameters(), lr=args.lr, warmup_steps=20)
    step = make_step(model, tx)

    before = validate_detector(detector(model), val_dataset, val_loader)
    print(f"mAP50 before training: {before['map50']:.4f}")
    kerr_before = None
    if args.kpts:
        kerr_before, n_before = _kpt_pixel_error(detector(model), val_images, val_boxes, val_masks, val_kpts)
        print(f"kpt pixel error before: {kerr_before} (n={n_before})")

    # the training set lives on the device; batches are drawn as the JAX demo draws them
    staged = [torch.from_numpy(a).to(device) for a in (images, boxes, masks, gt_kpts)]
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    for it in range(args.steps):
        idx = torch.from_numpy(rng.integers(0, len(images), args.batch)).to(device)
        loss, _parts = step(*(a[idx] for a in staged))
        if it % 50 == 0 or it == args.steps - 1:
            print(f"step {it}: loss {float(loss):.4f}")
    print(f"trained {args.steps} steps in {time.perf_counter() - t0:.1f}s")

    after = validate_detector(detector(model), val_dataset, val_loader)
    print(f"mAP50 after training: {after['map50']:.4f} (map {after['map']:.4f})")
    out = {"before": before, "after": after}
    if args.kpts:
        kerr_after, n_after = _kpt_pixel_error(detector(model), val_images, val_boxes, val_masks, val_kpts)
        print(f"kpt pixel error after: {kerr_after} (n={n_after})")
        out["kpt_px_err_before"] = kerr_before
        out["kpt_px_err_after"] = kerr_after
        out["kpt_faces_scored"] = n_after
    return out


def _main_rtdetr(args, device, train_set, val_dataset, val_loader):
    """RT-DETR from a seeded init with contrastive denoising, batches drawn
    by ``default_rng(1)`` as in the JAX demo. Returns {"before", "after",
    "losses"}: the mAPs and every step's loss."""
    from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel
    from facedet_tpu_torch.models.init import random_init
    from facedet_tpu_torch.models.rtdetr import RTDETR_VARIANTS, RtDetr
    from facedet_tpu_torch.tools.misc import validate_detector
    from facedet_tpu_torch.train.rtdetr_train import make_rtdetr_train_step, xyxy_to_cxcywh
    from facedet_tpu_torch.train.yolo_train import ClippedAdamW, WarmupCosineDecay

    images, boxes, masks = train_set
    cxcywh = xyxy_to_cxcywh(torch.from_numpy(boxes).float(), float(args.size))
    variant = args.variant or "rtdetr-tiny"
    cfg = RTDETR_VARIANTS[variant]
    model = RtDetr(cfg)
    random_init(model, 0)
    model.to(device)
    lr = args.lr if args.lr != 2e-3 else 4e-4  # the DETR default
    schedule = WarmupCosineDecay(lr, min(100, args.steps // 10), args.steps, lr * 0.05)
    tx = ClippedAdamW(model.parameters(), schedule, weight_decay=1e-4, max_norm=0.1)
    step = make_rtdetr_train_step(model, tx, dn_groups=args.dn_groups, seed=2)

    def detector(model):
        # DETR's focal-loss confidences run low: COCO mAP ranks from conf 0.05
        det = RtDetrDetectionModel(variant=variant, dtype="float32", confidence_threshold=0.05,
                                   image_size=args.size, load_at_init=False, device=device)
        det.cfg = cfg
        det.model = copy.deepcopy(model).eval()
        return det

    before = validate_detector(detector(model), val_dataset, val_loader)
    print(f"mAP50 before training: {before['map50']:.4f}")
    staged = [torch.from_numpy(images).to(device), cxcywh.to(device), torch.from_numpy(masks).to(device)]
    rng = np.random.default_rng(1)
    losses = []
    t0 = time.perf_counter()
    for it in range(args.steps):
        idx = torch.from_numpy(rng.integers(0, len(images), args.batch)).to(device)
        loss, parts = step(*(a[idx] for a in staged))
        losses.append(loss)
        if it % 100 == 0 or it == args.steps - 1:
            extra = f" dn {float(parts['dn']):.3f}" if "dn" in parts else ""
            print(f"step {it}: loss {float(loss):.4f}{extra}")
    print(f"trained {args.steps} steps in {time.perf_counter() - t0:.1f}s")

    after = validate_detector(detector(model), val_dataset, val_loader)
    print(f"mAP50 after training: {after['map50']:.4f} (map {after['map']:.4f})")
    return {"before": before, "after": after, "losses": torch.stack(losses).tolist()}


if __name__ == "__main__":
    main()
