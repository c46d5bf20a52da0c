"""Fine-tune YOLOv11 on the reference-golden WIDERFACE images and score the
trained weights through the real sliced pipeline against the reference's own
detections.

The reference commits real WIDERFACE images together with its pipeline's
detection artifacts (temp_streamlit/<image>/crops, recovered into
facedet_tpu/eval/assets/reference_goldens.json by tools/reference_goldens.py).
Training on the reference's detections and replaying inference at its fixed
operating point (640/0.25/IOS/0.5 — reference:
pipeline_v4_yolo/1_Inference.py:563-566) exercises every stage the reference
exercises: data -> TAL/DFL training -> checkpoint -> sliced inference ->
merge -> box agreement. The train and held-out splits are reported apart:
a few images prove the pipeline, not WIDERFACE-scale generalisation.

Run: python -m facedet_tpu_torch.tools.golden_finetune --ref-dir <reference
checkout> [--goldens <goldens.json>] [--staged 64] [--device cuda]

Counterpart of facedet_tpu/tools/golden_finetune.py. The data half
(``load_golden_dataset`` to ``sample_batch``, ``cv_folds``,
``make_dense_blob_batches``) is the JAX module's numpy and PIL, copied: one
``np.random.default_rng`` gives the same batches bit for bit. The training
half runs on the port's train/yolo_train.py, train/scrfd_train.py and
train/rtdetr_train.py:

* optax's ``warmup_cosine_decay_schedule`` and ``clip_by_global_norm`` +
  ``adamw`` are ``WarmupCosineDecay`` and ``ClippedAdamW``;
* the staged loop's flips are inputs (``flips=``: one ``[spd, B]`` draw per
  dispatch, as JAX's ``PRNGKey(3 + seed)`` split per dispatch gives them),
  by default from the loop's generator seeded with ``3 + seed``;
* the EMA shadow follows the parameters (the BatchNorm statistics are the
  live model's, as JAX's EMA covers ``params`` only), decayed per dispatch
  by ``min(ema ** spd, (1 + n) / (10 + n))`` in the staged mode and per step
  by ``min(ema, (1 + it) / (10 + it))`` otherwise, in Python floats;
* the detector scored by ``parity_on_split`` runs the float32 model: the JAX
  ``make_det`` asks for a bfloat16 YOLO detector and then sets the float32
  training config and model on it, so it computes in float32 (ROADMAP §3);
* checkpoints are flax ``.npz`` files (models/from_jax.to_jax_variables)
  that both packages load.

Outputs go under ``--out-dir`` (default runs/golden_finetune/).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import time

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the JAX package's committed assets: read here, never written
_ASSETS = os.path.join(_REPO, "facedet_tpu", "eval", "assets")
GOLDENS_PATH = os.path.join(_ASSETS, "reference_goldens.json")
KEYPOINTS_PATH = os.path.join(_ASSETS, "golden_keypoints.json")
# a checkout of the reference repository, whose run artifacts the goldens index
REF_DIR = os.path.join(_REPO, "reference")
# where the tools' flags that commit an artifact write it
PORT_ASSETS = os.path.join(_REPO, "facedet_tpu_torch", "eval", "assets")

__all__ = [
    "load_golden_dataset",
    "split_records",
    "sample_crop",
    "sample_mosaic",
    "sample_batch",
    "cv_folds",
    "parity_on_split",
    "train_yolo",
    "main_cv",
    "main",
    "make_dense_blob_batches",
    "teacher_label_crops",
    "main_rtdetr",
]


def load_golden_dataset(
    goldens_path: str = GOLDENS_PATH,
    ref_dir: str = REF_DIR,
    keypoints_path: str | None = KEYPOINTS_PATH,
    min_conf: float = 0.2,
) -> list[dict]:
    """[{name, image uint8 [H,W,3], boxes float32 [N,4] xyxy, kpts float32
    [N,5,3]}] for every golden image whose source file exists. Keypoints come
    from tools/golden_keypoints.py's recovered landmarks (zeros = none).

    ``min_conf`` drops golden faces whose recorded confidence tops out below
    it — the dense parade dirs were produced by a conf-0.01 eval run, and
    near-zero-confidence reference detections are noise, not supervision."""
    from facedet_tpu_torch.data.native_loader import load_image

    with open(goldens_path) as f:
        goldens = json.load(f)
    kp_images = {}
    if keypoints_path and os.path.exists(keypoints_path):
        with open(keypoints_path) as f:
            kp_images = json.load(f).get("images", {})
    records = []
    for name, rec in sorted(goldens["images"].items()):
        src = os.path.join(ref_dir, name, "temp_sahi_input.jpg")
        if not os.path.exists(src):
            continue
        keep = [i for i, f in enumerate(rec["faces"]) if f["conf_hi"] >= min_conf]
        boxes = np.array(
            [rec["faces"][i]["bbox"] for i in keep], np.float32
        ).reshape(-1, 4)
        kpts = np.zeros((len(boxes), 5, 3), np.float32)
        if name in kp_images:
            kp_faces = kp_images[name]["faces"]
            for j, i in enumerate(keep):
                if i < len(kp_faces):
                    kpts[j] = np.asarray(kp_faces[i]["kpts"], np.float32)
        records.append(
            {"name": name, "image": load_image(src), "boxes": boxes, "kpts": kpts}
        )
    return records


def split_records(records: list[dict], holdout_every: int = 4):
    """Deterministic train/held-out split: every ``holdout_every``-th record
    (sorted by name) is held out — 12 train / 4 held-out on the full set."""
    train = [r for i, r in enumerate(records) if i % holdout_every != holdout_every - 1]
    held = [r for i, r in enumerate(records) if i % holdout_every == holdout_every - 1]
    return train, held


def _remap_boxes(
    boxes: np.ndarray, x0: float, y0: float, win: float, out: int,
    min_visible: float = 0.4, min_px: float = 3.0, kpts: np.ndarray | None = None,
):
    """Shift boxes into a window at (x0,y0) of size ``win``, scale to ``out``,
    clip, and drop boxes with <``min_visible`` of their area left visible.
    ``kpts`` [N,5,3] remap with their boxes (visibility zeroed outside the
    window). Returns boxes [M,4] (and kpts [M,5,3] when given)."""
    if len(boxes) == 0:
        empty_k = np.zeros((0, 5, 3), np.float32)
        return (boxes.reshape(0, 4), empty_k) if kpts is not None else boxes.reshape(0, 4)
    b = boxes - np.array([x0, y0, x0, y0], np.float32)
    area = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    c = np.clip(b, 0, win)
    c_area = np.maximum(c[:, 2] - c[:, 0], 0) * np.maximum(c[:, 3] - c[:, 1], 0)
    keep = c_area >= min_visible * np.maximum(area, 1e-9)
    c = c[keep] * (out / win)
    wh = c[:, 2:] - c[:, :2]
    keep2 = (wh[:, 0] >= min_px) & (wh[:, 1] >= min_px)
    c = c[keep2]
    if kpts is None:
        return c
    k = kpts[keep][keep2].copy()
    if len(k):
        k[..., 0] = (k[..., 0] - x0) * (out / win)
        k[..., 1] = (k[..., 1] - y0) * (out / win)
        inside = (
            (k[..., 0] >= 0) & (k[..., 0] < out) & (k[..., 1] >= 0) & (k[..., 1] < out)
        )
        k[..., 2] = k[..., 2] * inside
        k[..., :2] *= (k[..., 2:3] > 0)  # zero coords of invisible landmarks
    return c, k


def sample_crop(
    rec: dict, rng: np.random.Generator, out: int = 640,
    scale_range: tuple[float, float] = (0.6, 1.6), max_boxes: int = 64,
):
    """One training example: a face-anchored random window resized to
    ``out`` x ``out`` (PIL bilinear), boxes remapped, random h-flip.
    ``scale_range`` > 1 zooms out (faces shrink)."""
    from PIL import Image

    img, boxes = rec["image"], rec["boxes"]
    h, w = img.shape[:2]
    win = int(out * rng.uniform(*scale_range))
    win = min(win, h, w)
    if len(boxes):
        fx1, fy1, fx2, fy2 = boxes[rng.integers(len(boxes))]
        cx = (fx1 + fx2) / 2 + rng.uniform(-0.3, 0.3) * win
        cy = (fy1 + fy2) / 2 + rng.uniform(-0.3, 0.3) * win
    else:
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
    x0 = int(np.clip(cx - win / 2, 0, w - win))
    y0 = int(np.clip(cy - win / 2, 0, h - win))
    crop = img[y0 : y0 + win, x0 : x0 + win]
    if win != out:
        crop = np.asarray(
            Image.fromarray(crop).resize((out, out), Image.BILINEAR)
        )
    rec_kpts = rec.get("kpts")
    if rec_kpts is None:
        rec_kpts = np.zeros((len(boxes), 5, 3), np.float32)
    b, k = _remap_boxes(boxes, x0, y0, win, out, kpts=rec_kpts)
    if rng.random() < 0.5:
        crop = crop[:, ::-1]
        if len(b):
            b = np.stack([out - b[:, 2], b[:, 1], out - b[:, 0], b[:, 3]], -1)
            k = k.copy()
            k[..., 0] = (out - k[..., 0]) * (k[..., 2] > 0)
            # mirroring swaps left/right landmark semantics (flip_idx)
            k = k[:, [1, 0, 2, 4, 3]]
    b, k = b[:max_boxes], k[:max_boxes]
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_mask = np.zeros((max_boxes,), bool)
    out_kpts = np.zeros((max_boxes, 5, 3), np.float32)
    out_boxes[: len(b)] = b
    out_mask[: len(b)] = True
    out_kpts[: len(k)] = k
    # uint8 crops: batches ship at 1 B/px and are normalised on the device
    return np.ascontiguousarray(crop), out_boxes, out_mask, out_kpts


def sample_mosaic(records, rng, out: int, max_boxes: int,
                  scale_range: tuple[float, float] = (0.6, 1.6)):
    """4-quadrant mosaic of independent face-anchored crops (the reference
    trains with mosaic=1.0, pipeline_v3_RTDETR/train_rtdetr.py:191-207) —
    multiplies scene diversity on tiny datasets."""
    half = out // 2
    canvas = np.zeros((out, out, 3), np.uint8)
    acc, acc_k = [], []
    for oy, ox in ((0, 0), (0, half), (half, 0), (half, half)):
        rec = records[rng.integers(len(records))]
        img, b, m, k = sample_crop(rec, rng, out=half, max_boxes=max_boxes,
                                   scale_range=scale_range)
        canvas[oy : oy + half, ox : ox + half] = img
        if m.any():
            acc.append(b[m] + np.array([ox, oy, ox, oy], np.float32))
            kk = k[m].copy()
            kk[..., 0] += ox * (kk[..., 2] > 0)
            kk[..., 1] += oy * (kk[..., 2] > 0)
            acc_k.append(kk)
    b = (np.concatenate(acc) if acc else np.zeros((0, 4), np.float32))[:max_boxes]
    k = (np.concatenate(acc_k) if acc_k else np.zeros((0, 5, 3), np.float32))[:max_boxes]
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_mask = np.zeros((max_boxes,), bool)
    out_kpts = np.zeros((max_boxes, 5, 3), np.float32)
    out_boxes[: len(b)] = b
    out_mask[: len(b)] = True
    out_kpts[: len(k)] = k
    return canvas, out_boxes, out_mask, out_kpts


def _photometric_jitter(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Cheap brightness/contrast/channel-gain jitter (stand-in for the
    reference's HSV jitter) applied to a uint8 crop."""
    gain = rng.uniform(0.75, 1.25, 3).astype(np.float32)
    bias = rng.uniform(-20, 20)
    return np.clip(img.astype(np.float32) * gain + bias, 0, 255).astype(np.uint8)


def sample_batch(records, rng, batch: int, out: int = 640, max_boxes: int = 64,
                 mosaic_prob: float = 0.0, jitter: bool = False,
                 scale_range: tuple[float, float] = (0.6, 1.6)):
    ims, bxs, mks, kps = [], [], [], []
    for _ in range(batch):
        if mosaic_prob and rng.random() < mosaic_prob:
            img, b, m, k = sample_mosaic(records, rng, out, max_boxes,
                                         scale_range=scale_range)
        else:
            img, b, m, k = sample_crop(
                records[rng.integers(len(records))], rng, out=out,
                max_boxes=max_boxes, scale_range=scale_range,
            )
        if jitter:
            img = _photometric_jitter(img, rng)
        ims.append(img)
        bxs.append(b)
        mks.append(m)
        kps.append(k)
    return np.stack(ims), np.stack(bxs), np.stack(mks), np.stack(kps)


def parity_on_split(detection_model, goldens: dict, records: list[dict],
                    ref_dir: str, conf: float, iou: float,
                    keypoints: dict | None = None) -> dict:
    from facedet_tpu_torch.eval.reference_parity import run_parity

    names = {r["name"] for r in records}
    subset = {
        "images": {k: v for k, v in goldens["images"].items() if k in names}
    }
    return run_parity(subset, ref_dir, detection_model, conf=conf, iou_thr=iou,
                      keypoints=keypoints)


def cv_folds(records: list[dict], n_folds: int = 4):
    """K-fold split by sorted-name index: fold f holds out every record with
    ``i % n_folds == f`` — every image is held out exactly once."""
    folds = []
    for f in range(n_folds):
        held = [r for i, r in enumerate(records) if i % n_folds == f]
        train = [r for i, r in enumerate(records) if i % n_folds != f]
        folds.append((train, held))
    return folds


def _ema_update_(shadow: list[torch.Tensor], live: list[torch.Tensor], dd: float) -> None:
    """``e = e * dd + p * (1 - dd)`` in place, each product rounded to the
    tensors' dtype before the sum, as ``jax.tree.map`` computes it with a
    Python-float ``dd``."""
    torch._foreach_mul_(shadow, dd)
    torch._foreach_add_(shadow, torch._foreach_mul(live, 1 - dd))


def _detector_state(model: torch.nn.Module, ema: list[torch.Tensor] | None) -> dict:
    """The model's state dict with the EMA shadow (when kept) in place of
    its parameters; buffers (BatchNorm statistics) are the live model's."""
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if ema is not None:
        for (name, _p), e in zip(model.named_parameters(), ema):
            state[name] = e.detach().clone()
    return state


def _make_det(family: str, variant: str, model: torch.nn.Module, state: dict, args, device):
    """A detector on a copy of ``model`` holding ``state``, in eval mode:
    the float32 model itself (the JAX ``make_det`` sets the float32 training
    config and model on its detector). ``det.train_state`` keeps the float32
    state for the checkpoint."""
    if family == "scrfd":
        from facedet_tpu_torch.engine.scrfd_wrapper import ScrfdDetectionModel

        det = ScrfdDetectionModel(
            variant=variant, dtype="float32", confidence_threshold=0.25, image_size=args.size,
            load_at_init=False, device=device,
        )
        det._onnx = None
    else:
        from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel

        det = YoloV11PoseDetectionModel(
            scale=args.scale, dtype="float32", confidence_threshold=0.25,
            image_size=args.size, load_at_init=False, device=device,
        )
    det.cfg = model.cfg
    det.model = copy.deepcopy(model).eval()
    det.model.load_state_dict(state)
    det.train_state = state
    return det


def _staged_flips(flips, n_dispatch: int):
    return None if flips is None else torch.as_tensor(np.asarray(flips[n_dispatch]), dtype=torch.bool)


def train_yolo(args, train_recs, seed: int = 0, eval_points=(), eval_hook=None,
               variables: dict | None = None, flips=None, history: list | None = None):
    """Train the detector family on ``train_recs``; returns
    (det_model, train_seconds). ``args.model`` picks yolo (default) or scrfd
    — both ride the same staged loop (scrfd injects its loss,
    train/scrfd_train.make_scrfd_staged_loop).

    ``eval_points``: ascending step counts at which ``eval_hook(step, det)``
    is called with a detector wrapping the CURRENT weights (used by the CV
    mode to score several step budgets in one run). ``variables``: flax
    variables to start from (a seeded random init when None). ``flips``:
    the staged loop's flip draws, one ``[spd, batch]`` array per dispatch.
    ``history`` (a list) receives ``(step, loss, seconds since the start)``
    at each print."""
    from facedet_tpu_torch.engine.detector import resolve_device
    from facedet_tpu_torch.models.from_jax import load_jax_variables
    from facedet_tpu_torch.models.init import random_init
    from facedet_tpu_torch.train.yolo_train import ClippedAdamW, WarmupCosineDecay

    device = resolve_device(getattr(args, "device", None))
    family = getattr(args, "model", "yolo")
    variant = None
    if family == "scrfd":
        from facedet_tpu_torch.models.scrfd import SCRFD_VARIANTS, Scrfd

        variant = (args.variant if args.variant in SCRFD_VARIANTS
                   else "scrfd_2.5g")
        model = Scrfd(dataclasses.replace(SCRFD_VARIANTS[variant], dtype="float32"))
    else:
        from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11

        model = YoloV11(YoloConfig(scale=args.scale, num_classes=1, with_pose=True))
    if variables is None:
        random_init(model, seed)
    else:
        load_jax_variables(model, variables)
    model = model.to(device)
    params = list(model.parameters())
    sched = WarmupCosineDecay(args.lr, min(100, args.steps // 10), args.steps, args.lr * 0.01)
    tx = ClippedAdamW(params, sched, weight_decay=5e-4, max_norm=10.0)

    def make_det():
        return _make_det(family, variant, model, _detector_state(model, ema), args, device)

    evals = sorted({int(e) for e in eval_points if 0 < int(e) <= args.steps})
    rng = np.random.default_rng(seed)
    max_boxes = 64
    scale_range = getattr(args, "scale_range_t", (0.6, 1.6))
    # the staged loop returns at dispatch boundaries only, so its shadow
    # updates per dispatch with the per-step decay compounded over the
    # dispatch: the same ~1/(1-d) averaging window as the per-step EMA
    ema_decay = getattr(args, "ema", 0.0)
    ema = None
    log = history if history is not None else []
    t0 = time.perf_counter()
    if args.staged:
        if family == "scrfd":
            from facedet_tpu_torch.train.scrfd_train import (
                make_scrfd_staged_loop as make_staged_train_loop,
            )
        else:
            from facedet_tpu_torch.train.yolo_train import make_staged_train_loop

        batches = [
            sample_batch(train_recs, rng, args.batch, args.size, max_boxes,
                         mosaic_prob=args.mosaic_prob, jitter=not args.no_jitter,
                         scale_range=scale_range)
            for _ in range(args.staged)
        ]
        staged = [torch.from_numpy(np.stack([b[j] for b in batches])).to(device) for j in range(4)]
        print(f"staged {args.staged} batches "
              f"({staged[0].numel() / 1e6:.0f} MB uint8) in "
              f"{time.perf_counter() - t0:.1f}s")
        spd = min(args.steps_per_dispatch, args.steps)
        # eval points snap UP to the dispatch boundary they fire at, so the
        # recorded step label is the trained step count
        evals = sorted({-(-e // spd) * spd for e in evals})
        run = make_staged_train_loop(model, tx, steps_per_dispatch=spd, seed=3 + seed)
        done = 0
        n_dispatch = 0
        while done < args.steps:
            mean_loss = run(*staged, start=done, flips=_staged_flips(flips, n_dispatch))
            done += spd
            if ema_decay:
                dd = min(ema_decay**spd, (1 + n_dispatch) / (10 + n_dispatch))
                if ema is None:
                    ema = [p.detach().clone() for p in params]
                else:
                    _ema_update_(ema, [p.detach() for p in params], dd)
            n_dispatch += 1
            loss = float(mean_loss)
            log.append((done, loss, round(time.perf_counter() - t0, 3)))
            print(f"step {done}: mean loss {loss:.4f}")
            while evals and done >= evals[0]:
                eval_hook(evals.pop(0), make_det())
    else:
        if family == "scrfd":
            from facedet_tpu_torch.train.scrfd_train import (
                make_scrfd_train_step as make_train_step,
            )
        else:
            from facedet_tpu_torch.train.yolo_train import make_train_step
        step = make_train_step(model, tx)
        for it in range(args.steps):
            ims, bxs, mks, kps = sample_batch(
                train_recs, rng, args.batch, args.size, max_boxes,
                mosaic_prob=args.mosaic_prob, jitter=not args.no_jitter,
                scale_range=scale_range,
            )
            # XLA's u / 255: a multiply by the float32 reciprocal
            images = torch.from_numpy(ims).to(device).float() * (1.0 / 255.0)
            loss, _ = step(images, torch.from_numpy(bxs), torch.from_numpy(mks), torch.from_numpy(kps))
            if ema_decay:
                dd = min(ema_decay, (1 + it) / (10 + it))
                if ema is None:
                    ema = [p.detach().clone() for p in params]
                else:
                    _ema_update_(ema, [p.detach() for p in params], dd)
            if it % 100 == 0 or it == args.steps - 1:
                log.append((it, float(loss), round(time.perf_counter() - t0, 3)))
                print(f"step {it}: loss {float(loss):.4f}")
            while evals and it + 1 >= evals[0]:
                eval_hook(evals.pop(0), make_det())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    return make_det(), train_s


def _ckpt_stem(args) -> str:
    if getattr(args, "model", "yolo") == "scrfd":
        v = args.variant if args.variant.startswith("scrfd") else "scrfd_2.5g"
        return v.replace(".", "_")
    return f"yolo11{args.scale}"


def _save_det(path: str, det) -> None:
    from facedet_tpu_torch.engine.detector import save_params_npz
    from facedet_tpu_torch.models.from_jax import to_jax_variables

    save_params_npz(path, to_jax_variables(det.train_state))


def main_cv(args, records, goldens, keypoints):
    """K-fold cross-validated golden fine-tune: every image held out once,
    several step budgets scored per fold, aggregate mean +- spread reported,
    final checkpoint trained on ALL records at the CV-chosen step count."""
    eval_points = sorted(
        getattr(args, "eval_points_t", None) or {args.steps // 2, args.steps}
    )
    folds = cv_folds(records, args.cv)
    fold_rows = []
    for f, (train_f, held_f) in enumerate(folds):
        print(f"--- fold {f + 1}/{len(folds)}: "
              f"{len(train_f)} train / {len(held_f)} held ---")
        results = {}

        def hook(step_count, det, _held=held_f, _res=results, _f=f):
            r = parity_on_split(det, goldens, _held, args.ref_dir,
                                args.conf, args.iou, keypoints=keypoints)
            _res[step_count] = {
                "recall": r["recall"], "precision": r["precision"],
                "mean_kpt_nme": r.get("mean_kpt_nme"),
                "kpt_faces_scored": r.get("kpt_faces_scored"),
            }
            print(f"  fold {_f} @ step {step_count}: "
                  f"recall {r['recall']:.3f} precision {r['precision']:.3f}")

        _det, train_s = train_yolo(
            args, train_f, seed=f, eval_points=eval_points, eval_hook=hook
        )
        fold_rows.append({"fold": f, "train_seconds": round(train_s, 1),
                          "held_images": [r["name"] for r in held_f],
                          "results": results})

    agg = {}
    # aggregate over the step labels actually recorded (staged mode snaps
    # requested eval points to dispatch boundaries), not the requested ones
    eval_points = sorted({k for fr in fold_rows for k in fr["results"]})
    for sp in eval_points:
        recalls = [fr["results"][sp]["recall"] for fr in fold_rows
                   if sp in fr["results"]]
        precs = [fr["results"][sp]["precision"] for fr in fold_rows
                 if sp in fr["results"]]
        agg[sp] = {
            "recall_mean": float(np.mean(recalls)),
            "recall_min": float(np.min(recalls)),
            "recall_max": float(np.max(recalls)),
            "precision_mean": float(np.mean(precs)),
            "precision_min": float(np.min(precs)),
            "precision_max": float(np.max(precs)),
        }
        print(f"CV @ {sp} steps: recall {agg[sp]['recall_mean']:.3f} "
              f"[{agg[sp]['recall_min']:.3f}-{agg[sp]['recall_max']:.3f}] "
              f"precision {agg[sp]['precision_mean']:.3f}")
    best_steps = max(agg, key=lambda sp: agg[sp]["recall_mean"])
    print(f"CV-chosen step count: {best_steps}")

    # final checkpoint: ALL records at the CV-chosen budget
    args.steps = best_steps
    det, train_s = train_yolo(args, records, seed=101)
    os.makedirs(args.out_dir, exist_ok=True)
    ckpt = os.path.join(args.out_dir, f"{_ckpt_stem(args)}_golden_cv.npz")
    _save_det(ckpt, det)
    full = parity_on_split(det, goldens, records, args.ref_dir,
                           args.conf, args.iou, keypoints=keypoints)
    report = {
        "mode": f"{args.cv}-fold CV",
        "eval_points": eval_points,
        "folds": fold_rows,
        "aggregate": {str(k): v for k, v in agg.items()},
        "cv_chosen_steps": best_steps,
        "final_checkpoint": ckpt,
        "final_train_seconds": round(train_s, 1),
        "final_all_data_parity": {
            "recall": full["recall"], "precision": full["precision"],
            "mean_kpt_nme": full.get("mean_kpt_nme"),
            "mean_kpt_px_err": full.get("mean_kpt_px_err"),
            "kpt_faces_scored": full.get("kpt_faces_scored"),
        },
    }
    out = os.path.join(args.out_dir, "cv_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}")
    return report


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 2e-3 for yolo, 4e-4 for rtdetr")
    ap.add_argument("--scale", default="n")
    ap.add_argument("--conf", type=float, default=0.35)
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--goldens", default=GOLDENS_PATH)
    ap.add_argument("--keypoints", default=KEYPOINTS_PATH,
                    help="recovered landmarks (tools/golden_keypoints.py)")
    ap.add_argument("--ref-dir", default=REF_DIR)
    ap.add_argument("--out-dir", default="runs/golden_finetune")
    ap.add_argument("--max-parity-images", type=int, default=0,
                    help="cap each parity split to N images (0 = all; for smokes)")
    ap.add_argument("--staged", type=int, default=0,
                    help="pre-stage N uint8 batches on the device and train with "
                    "the staged loop; 0 = host-driven per-step feeding")
    ap.add_argument("--steps-per-dispatch", type=int, default=100)
    ap.add_argument("--mosaic-prob", type=float, default=0.4,
                    help="probability of a 4-quadrant mosaic sample (yolo path)")
    ap.add_argument("--no-jitter", action="store_true",
                    help="disable photometric jitter (yolo path)")
    ap.add_argument("--model", choices=("yolo", "rtdetr", "scrfd"), default="yolo",
                    help="rtdetr = pipeline-v3 analog: CDN-trained RT-DETR "
                    "on the golden images (staged loop only)")
    ap.add_argument("--variant", default="rtdetr-m",
                    help="RTDETR_VARIANTS key for --model rtdetr")
    ap.add_argument("--dn-groups", type=int, default=3)
    ap.add_argument("--pretrain-steps", type=int, default=0,
                    help="rtdetr: synthetic dense-blob pretrain steps before "
                    "the golden fine-tune (pretrained-init stand-in)")
    ap.add_argument("--teacher", default=None,
                    help="rtdetr: path to a trained YOLO .npz — its "
                    "detections on the staged crops replace the recovered GT")
    ap.add_argument("--teacher-conf", type=float, default=0.30)
    ap.add_argument("--cv", type=int, default=0,
                    help="K-fold cross-validation: every golden image held "
                    "out once, step count picked on CV mean, final "
                    "checkpoint trained on all data (yolo path)")
    ap.add_argument("--ema", type=float, default=0.0,
                    help="per-step EMA decay for an evaluation/checkpoint "
                    "shadow of the params (0 = off; staged mode compounds it "
                    "per dispatch)")
    ap.add_argument("--scale-range", default="0.6,1.6",
                    help="crop window scale range lo,hi in units of --size; "
                    "hi > 1.6 zooms out harder (smaller faces in view)")
    ap.add_argument("--eval-points", default=None,
                    help="CV mode: comma list of step budgets to score per "
                    "fold (default: steps/2,steps); each must be <= --steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs here)")
    return ap


def _load_json(path: str | None):
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def main(argv=None):
    args = _parser().parse_args(argv)
    args.scale_range_t = tuple(float(x) for x in args.scale_range.split(","))
    args.eval_points_t = (
        {int(x) for x in args.eval_points.split(",")} if args.eval_points
        else None
    )
    if args.model == "rtdetr":
        return main_rtdetr(args)
    if args.lr is None:
        args.lr = 2e-3

    records = load_golden_dataset(args.goldens, args.ref_dir, args.keypoints)
    if not records:
        raise SystemExit(f"no golden source images under {args.ref_dir}")

    with open(args.goldens) as f:
        goldens = json.load(f)
    keypoints = _load_json(args.keypoints)

    if args.cv:
        return main_cv(args, records, goldens, keypoints)

    train_recs, held_recs = split_records(records)
    n_faces = sum(len(r["boxes"]) for r in records)
    print(f"{len(records)} golden images / {n_faces} faces "
          f"({len(train_recs)} train, {len(held_recs)} held out)")

    history: list = []
    det, train_s = train_yolo(args, train_recs, history=history)
    print(f"trained {args.steps} steps in {train_s:.1f}s")

    os.makedirs(args.out_dir, exist_ok=True)
    ckpt = os.path.join(args.out_dir, f"{_ckpt_stem(args)}_golden.npz")
    _save_det(ckpt, det)
    print(f"saved {ckpt}")

    cap = args.max_parity_images or None
    report = {
        "steps": args.steps, "train_seconds": round(train_s, 1),
        "checkpoint": ckpt,
        "loss_history": history,
        "train_split": parity_on_split(
            det, goldens, train_recs[:cap], args.ref_dir, args.conf, args.iou,
            keypoints=keypoints),
        "held_out_split": parity_on_split(
            det, goldens, held_recs[:cap], args.ref_dir, args.conf, args.iou,
            keypoints=keypoints),
    }
    for split in ("train_split", "held_out_split"):
        r = report[split]
        rec = "n/a" if r["recall"] is None else f"{r['recall']:.3f}"
        prec = "n/a" if r["precision"] is None else f"{r['precision']:.3f}"
        kpt = (f" kpt_nme {r['mean_kpt_nme']:.3f}"
               f" ({r['mean_kpt_px_err']:.1f}px, n={r['kpt_faces_scored']})"
               if "mean_kpt_nme" in r else "")
        print(f"{split}: recall {rec} precision {prec}"
              f" (conf>={args.conf}, IoU>={args.iou}){kpt}")
    out = os.path.join(args.out_dir, "parity_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}")
    return report


def _xyxy_to_norm_cxcywh(xyxy: np.ndarray, size: float) -> np.ndarray:
    """Pixel xyxy [..., 4] -> normalized cxcywh for the DETR losses."""
    return np.stack(
        [
            (xyxy[..., 0] + xyxy[..., 2]) / 2 / size,
            (xyxy[..., 1] + xyxy[..., 3]) / 2 / size,
            (xyxy[..., 2] - xyxy[..., 0]) / size,
            (xyxy[..., 3] - xyxy[..., 1]) / size,
        ],
        -1,
    ).astype(np.float32)


def make_dense_blob_batches(
    n_batches: int, batch: int, size: int, max_boxes: int,
    rng: np.random.Generator,
):
    """Synthetic dense-crowd pretraining batches shaped like the golden crop
    batches: uint8 images with 8-64px bright ellipse 'faces' on textured
    background, up to ``max_boxes`` per image, plus pixel-xyxy GT."""
    yy, xx = np.mgrid[0:size, 0:size]
    ims = np.zeros((n_batches, batch, size, size, 3), np.uint8)
    bxs = np.zeros((n_batches, batch, max_boxes, 4), np.float32)
    mks = np.zeros((n_batches, batch, max_boxes), bool)
    for n in range(n_batches):
        for b in range(batch):
            img = rng.uniform(0, 64, (size, size, 3)).astype(np.float32)
            k = int(rng.integers(4, max_boxes))
            for j in range(k):
                rx = int(rng.integers(4, 32))
                ry = int(rx * rng.uniform(1.1, 1.5))
                cx = int(rng.integers(rx + 1, size - rx - 1))
                cy = int(rng.integers(ry + 1, size - ry - 1))
                m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
                img[m] = rng.uniform(120, 255, 3)
                bxs[n, b, j] = [cx - rx, cy - ry, cx + rx, cy + ry]
                mks[n, b, j] = True
            ims[n, b] = img.astype(np.uint8)
    return ims, bxs, mks


def teacher_label_crops(
    images_u8: np.ndarray, teacher_ckpt: str, conf: float, max_boxes: int,
    fwd_batch: int = 16, scale: str = "n", device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Label crops with a trained YOLO checkpoint's detections: the golden
    YOLO acts as teacher and its boxes become RT-DETR's targets — denser and
    more consistent than the sparse recovered GT remapped through random
    crops. The float32 teacher's ``tile_forward`` runs on chunks of
    ``fwd_batch`` crops, the last padded with zeros to that batch. Returns
    pixel-xyxy boxes [N, max_boxes, 4] + validity mask [N, max_boxes]."""
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel

    det = YoloV11PoseDetectionModel(
        model_path=teacher_ckpt, scale=scale, dtype="float32",
        confidence_threshold=conf, image_size=images_u8.shape[1], device=device,
    )
    n = images_u8.shape[0]
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    mask = np.zeros((n, max_boxes), bool)
    for i in range(0, n, fwd_batch):
        chunk = images_u8[i : i + fwd_batch]
        pad = fwd_batch - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.zeros_like(chunk[:pad])])
        tiles = torch.from_numpy(chunk).to(det.device).float() * (1.0 / 255.0)
        d = det.tile_forward(tiles, conf)
        scores, valid, dboxes = (t.cpu().numpy() for t in (d.scores, d.valid, d.boxes))
        for j in range(chunk.shape[0] - pad):
            order = np.argsort(-scores[j])
            sel = order[valid[j][order]][:max_boxes]
            boxes[i + j, : len(sel)] = dboxes[j, sel]
            mask[i + j, : len(sel)] = True
    return boxes, mask


def main_rtdetr(args):
    """RT-DETR on the golden WIDERFACE images — the real-data analog of the
    reference's pipeline v3 fine-tune (pipeline_v3_RTDETR/train_rtdetr.py:162:
    it trains RT-DETR on WIDERFACE); from a seeded init with contrastive
    denoising. Staged loop only. ``--pretrain-steps`` prepends a synthetic
    dense-blob localisation pretrain, a stand-in for the reference's
    COCO-pretrained initialisation."""
    from facedet_tpu_torch.engine.detector import resolve_device, save_params_npz
    from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel
    from facedet_tpu_torch.models.from_jax import attention_heads, to_jax_variables
    from facedet_tpu_torch.models.init import random_init
    from facedet_tpu_torch.models.rtdetr import RTDETR_VARIANTS, RtDetr
    from facedet_tpu_torch.train.rtdetr_train import make_staged_rtdetr_loop
    from facedet_tpu_torch.train.yolo_train import ClippedAdamW, WarmupCosineDecay

    device = resolve_device(args.device)
    records = load_golden_dataset(args.goldens, args.ref_dir, args.keypoints)
    if not records:
        raise SystemExit(f"no golden source images under {args.ref_dir}")
    train_recs, held_recs = split_records(records)
    print(f"{len(records)} golden images ({len(train_recs)} train, "
          f"{len(held_recs)} held out)")

    variant = args.variant
    cfg = RTDETR_VARIANTS[variant]
    # keep GT capacity under the tiny variant's 60 queries
    max_boxes = min(48, cfg.num_queries)
    model = RtDetr(cfg)
    random_init(model, 0)
    model = model.to(device)
    lr = 4e-4 if args.lr is None else args.lr  # DETR-appropriate default
    total_steps = args.steps + args.pretrain_steps
    sched = WarmupCosineDecay(lr, min(100, total_steps // 10), total_steps, lr * 0.05)
    tx = ClippedAdamW(model.parameters(), sched, weight_decay=1e-4, max_norm=0.1)

    rng = np.random.default_rng(0)
    n_staged = args.staged or 64
    t0 = time.perf_counter()
    batches = [
        sample_batch(train_recs, rng, args.batch, args.size, max_boxes)
        for _ in range(n_staged)
    ]
    s = float(args.size)
    ims_np = np.stack([b[0] for b in batches])  # [N,B,S,S,3] uint8
    if args.teacher:
        t0l = time.perf_counter()
        t_boxes, t_mask = teacher_label_crops(
            ims_np.reshape(-1, args.size, args.size, 3),
            args.teacher, args.teacher_conf, max_boxes, device=device,
        )
        xyxy = t_boxes.reshape(n_staged, args.batch, max_boxes, 4)
        mks_np = t_mask.reshape(n_staged, args.batch, max_boxes)
        print(f"teacher-labelled {t_mask.shape[0]} crops "
              f"({int(t_mask.sum())} boxes, conf>={args.teacher_conf}) "
              f"in {time.perf_counter() - t0l:.1f}s")
    else:
        xyxy = np.stack([b[1] for b in batches])  # [N,B,M,4] pixel xyxy
        mks_np = np.stack([b[2] for b in batches])
    staged = [torch.from_numpy(a).to(device) for a in (ims_np, _xyxy_to_norm_cxcywh(xyxy, s), mks_np)]
    print(f"staged {n_staged} batches ({staged[0].numel() / 1e6:.0f} MB uint8) "
          f"in {time.perf_counter() - t0:.1f}s")

    spd = min(args.steps_per_dispatch, args.steps)
    run = make_staged_rtdetr_loop(model, tx, steps_per_dispatch=spd,
                                  dn_groups=args.dn_groups, seed=3)
    history = []
    if args.pretrain_steps:
        # the same staged shapes as the fine-tune
        pt_ims, pt_xyxy, pt_mks = make_dense_blob_batches(
            n_staged, args.batch, args.size, max_boxes,
            np.random.default_rng(11),
        )
        pretrain = [torch.from_numpy(a).to(device) for a in (pt_ims, _xyxy_to_norm_cxcywh(pt_xyxy, s), pt_mks)]
        done = 0
        while done < args.pretrain_steps:
            mean_loss = float(run(*pretrain, start=done))
            done += spd
            print(f"pretrain step {done}: mean loss {mean_loss:.4f}")
    done = 0
    while done < args.steps:
        mean_loss = float(run(*staged, start=done))
        done += spd
        history.append((done, mean_loss, round(time.perf_counter() - t0, 3)))
        print(f"step {done}: mean loss {mean_loss:.4f}")
    train_s = time.perf_counter() - t0
    print(f"trained {args.steps} steps in {train_s:.1f}s")

    os.makedirs(args.out_dir, exist_ok=True)
    ckpt = os.path.join(args.out_dir, f"{variant}_golden.npz")
    save_params_npz(ckpt, to_jax_variables(model.state_dict(), attention_heads(model)))
    print(f"saved {ckpt}")

    # DETR focal-loss confidences run low (reference validates at 0.001 via
    # model.val); score the parity gate at an inclusive operating threshold
    det = RtDetrDetectionModel(
        variant=variant, dtype="float32", confidence_threshold=0.05,
        image_size=args.size, load_at_init=False, device=device,
    )
    det.cfg = cfg
    det.model = model.eval()

    with open(args.goldens) as f:
        goldens = json.load(f)
    cap = args.max_parity_images or None
    conf = min(args.conf, 0.2)
    report = {
        "model": variant, "steps": args.steps,
        "train_seconds": round(train_s, 1), "checkpoint": ckpt,
        "loss_history": history,
        "train_split": parity_on_split(
            det, goldens, train_recs[:cap], args.ref_dir, conf, args.iou),
        "held_out_split": parity_on_split(
            det, goldens, held_recs[:cap], args.ref_dir, conf, args.iou),
    }
    for split in ("train_split", "held_out_split"):
        r = report[split]
        rec = "n/a" if r["recall"] is None else f"{r['recall']:.3f}"
        prec = "n/a" if r["precision"] is None else f"{r['precision']:.3f}"
        print(f"{split}: recall {rec} precision {prec}"
              f" (conf>={conf}, IoU>={args.iou})")
    out = os.path.join(args.out_dir, "parity_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}")
    return report


if __name__ == "__main__":
    main()
