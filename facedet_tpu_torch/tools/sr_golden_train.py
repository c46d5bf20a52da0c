"""Train the Real-ESRGAN arm on the golden images and prove it enhances.

The reference's third pillar is a *trained* enhancer with measured perceptual
gains on face crops (utils/enhancer.py:99-156 loads RealESRGAN weights;
hasil eval niqe.txt:15-16 reports BRISQUE 30.9->23.8, TOPIQ 0.30->0.44).
This tool trains RRDBNet self-supervised on the recovered golden WIDERFACE
scenes (degrade -> restore, the Real-ESRGAN practical degradation model —
train/sr_train.py) and then publishes the two kinds of evidence:

1. **Ground-truthed fidelity** (held-out images, not sampled for patches):
   degrade deterministically, restore with the trained net, report PSNR vs the
   original against a bicubic-upsample baseline.
2. **Perceptual table on real face crops** (the shape of hasil eval
   niqe.txt): NIQE/BRISQUE/TOPIQ on the golden faces before/after
   enhancement, overall and by size category.

Artifacts (default runs/sr_golden_train/): rrdb_x{scale}_golden.npz (EMA
weights, float16) and sr_report.json with its side-by-side grid.

Run: python -m facedet_tpu_torch.tools.sr_golden_train --ref-dir <reference
checkout> [--steps 4000] [--device cuda]

Counterpart of facedet_tpu/tools/sr_golden_train.py. The host helpers
(``collect_face_crops``, ``save_side_by_side``, ``iqa_table``, the size
rule) are copies; training runs on the port's train/sr_train.py (clip 5 +
Adam, the staged loop with its EMA), train/sr_gan.py and
train/perceptual.py, the flip draws from the loops' seeded generators.
``load_unique_golden_images`` takes the goldens and the reference tree
(the JAX function binds its defaults).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from facedet_tpu_torch.tools.golden_finetune import GOLDENS_PATH, REF_DIR

__all__ = [
    "load_unique_golden_images",
    "collect_face_crops",
    "enhance_crops",
    "save_side_by_side",
    "iqa_table",
    "fidelity_eval",
    "main",
]


def load_unique_golden_images(min_conf: float = 0.2, ref_dir: str = REF_DIR,
                              goldens: str = GOLDENS_PATH) -> list[dict]:
    """Golden records deduplicated by source content (the batch dirs repeat
    some scenes) — [{name, image, boxes}] via golden_finetune's loader."""
    from facedet_tpu_torch.tools.golden_finetune import load_golden_dataset

    records = load_golden_dataset(goldens, ref_dir, min_conf=min_conf)
    seen, unique = set(), []
    for r in records:
        key = (r["image"].shape, int(np.sum(r["image"][::97, ::97], dtype=np.int64)))
        if key in seen:
            continue
        seen.add(key)
        unique.append(r)
    return unique


def _size_category(w: float, h: float) -> str:
    """Subcategory size rule (scripts/classifier_face_level_2.py:163-203)."""
    s = max(w, h)
    return "small" if s < 50 else ("medium" if s < 150 else "large")


def collect_face_crops(
    records: list[dict], max_crops: int, min_side: int = 20, margin: float = 0.15,
    max_side: int = 360, seed: int = 0,
) -> list[dict]:
    """Real face crops from the golden boxes: [{crop u8, category, name}].
    Round-robins over images so one dense parade doesn't dominate."""
    rng = np.random.default_rng(seed)
    pools = []
    for r in records:
        h, w = r["image"].shape[:2]
        rows = []
        for b in np.asarray(r["boxes"], np.float64):
            bw, bh = b[2] - b[0], b[3] - b[1]
            if min(bw, bh) < min_side or max(bw, bh) > max_side:
                continue
            m = margin * max(bw, bh)
            x0, y0 = int(max(0, b[0] - m)), int(max(0, b[1] - m))
            x1, y1 = int(min(w, b[2] + m)), int(min(h, b[3] + m))
            if x1 - x0 < min_side or y1 - y0 < min_side:
                continue
            rows.append(
                {
                    "crop": r["image"][y0:y1, x0:x1].copy(),
                    "category": _size_category(bw, bh),
                    "name": r["name"],
                }
            )
        if rows:
            rng.shuffle(rows)
            pools.append(rows)
    crops, i = [], 0
    while len(crops) < max_crops and any(pools):
        pool = pools[i % len(pools)]
        if pool:
            crops.append(pool.pop())
        i += 1
        if i > 100000:
            break
        pools = [p for p in pools if p] or []
        if not pools:
            break
    return crops[:max_crops]


def enhance_crops(enhancer, crops: list[np.ndarray]) -> list[np.ndarray]:
    """Batch-enhance variable-size crops through shared size buckets: each
    crop is reflect-padded to its bucket, fixed-size bucket chunks run the
    net in one call each, outputs are cut back to (h*scale, w*scale)."""
    buckets: dict[int, list[int]] = {}
    sizes = (48, 96, 192, 384, 768)
    for i, c in enumerate(crops):
        s = max(c.shape[0], c.shape[1])
        b = next((x for x in sizes if s <= x), ((s + 127) // 128) * 128)
        buckets.setdefault(b, []).append(i)
    out: list = [None] * len(crops)
    scale = enhancer.cfg.scale
    px_budget = 12 * 420 * 420 // 2
    for b, idxs in sorted(buckets.items()):
        chunk = max(1, min(16, px_budget // (b * b)))
        for c0 in range(0, len(idxs), chunk):
            sel = idxs[c0 : c0 + chunk]
            batch = np.zeros((chunk, b, b, 3), np.float32)
            for j, i in enumerate(sel):
                c = crops[i].astype(np.float32) / 255.0
                h, w = c.shape[:2]
                batch[j] = np.pad(
                    c, ((0, b - h), (0, b - w), (0, 0)), mode="reflect"
                )
            x = torch.from_numpy(batch).permute(0, 3, 1, 2)
            # _net clips to [0, 1]
            res = (enhancer._net(x) * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
            for j, i in enumerate(sel):
                h, w = crops[i].shape[:2]
                out[i] = res[j, : h * scale, : w * scale]
    return out


def save_side_by_side(
    crops: list[dict], enhanced: list[np.ndarray], path: str,
    n: int = 8, cell: int = 192,
) -> str:
    """Visual evidence grid: each row = [original (nearest-upsampled to the
    enhanced size) | enhanced], the side-by-side artifact VERDICT r3 #1 asks
    for. Picks the n largest-gain small/medium crops by area order."""
    from PIL import Image

    order = sorted(range(len(crops)), key=lambda i: crops[i]["crop"].shape[0] * crops[i]["crop"].shape[1])
    sel = [i for i in order if min(crops[i]["crop"].shape[:2]) >= 24][:n]
    rows = []
    for i in sel:
        o, e = crops[i]["crop"], enhanced[i]
        o_up = np.asarray(
            Image.fromarray(o).resize((e.shape[1], e.shape[0]), Image.NEAREST)
        )
        pair = np.concatenate([o_up, e], axis=1)
        ph, pw = pair.shape[:2]
        s = cell / ph
        pair = np.asarray(
            Image.fromarray(pair).resize((int(pw * s), cell), Image.NEAREST)
        )
        rows.append(pair)
    w = max(r.shape[1] for r in rows)
    canvas = np.zeros((cell * len(rows), w, 3), np.uint8)
    for j, r in enumerate(rows):
        canvas[j * cell : (j + 1) * cell, : r.shape[1]] = r
    Image.fromarray(canvas).save(path, quality=92)
    return path


def iqa_table(crops: list[dict], enhanced: list[np.ndarray]) -> dict:
    """Before/after NIQE/BRISQUE/TOPIQ, overall + per size category — the
    shape of the reference's hasil eval niqe.txt table."""
    from facedet_tpu_torch.eval.iqa import calculate_iqa_scores

    rows = []
    for rec, enh in zip(crops, enhanced):
        rows.append(
            {
                "category": rec["category"],
                "orig": calculate_iqa_scores(rec["crop"]),
                "enhanced": calculate_iqa_scores(enh),
            }
        )
    def agg(sel):
        sel = list(sel)
        if not sel:
            return None
        return {
            "n": len(sel),
            **{
                f"{metric}_{k}": round(
                    float(np.mean([r[k][metric] for r in sel])), 4
                )
                for metric in ("niqe", "brisque", "topiq_face")
                for k in ("orig", "enhanced")
            },
        }
    table = {"overall": agg(rows)}
    for cat in ("small", "medium", "large"):
        entry = agg(r for r in rows if r["category"] == cat)
        if entry:
            table[cat] = entry
    return table


def fidelity_eval(enhancer, holdout: list[dict], scale: int, max_hw: int = 1200) -> list[dict]:
    """Degrade (deterministic) -> restore on device -> PSNR vs original, with
    a bicubic-upsample baseline, per held-out image."""
    from PIL import Image

    from facedet_tpu_torch.train.sr_train import degrade_image, psnr

    out = []
    for r in holdout:
        img = r["image"]
        if max(img.shape[:2]) > max_hw:  # bound device/IQA cost per image
            h0, w0 = img.shape[:2]
            f = max_hw / max(h0, w0)
            img = np.asarray(
                Image.fromarray(img).resize(
                    (int(w0 * f) // scale * scale, int(h0 * f) // scale * scale),
                    Image.BICUBIC,
                )
            )
        h, w = img.shape[0] // scale * scale, img.shape[1] // scale * scale
        img = img[:h, :w]
        lr = degrade_image(img, scale)
        restored, _dt = enhancer.enhance_image(lr, outscale=scale)
        bicubic = np.asarray(
            Image.fromarray(lr).resize((w, h), Image.BICUBIC)
        )
        out.append(
            {
                "image": r["name"],
                "hw": [h, w],
                "psnr_bicubic": round(psnr(bicubic, img), 3),
                "psnr_restored": round(psnr(restored[:h, :w], img), 3),
            }
        )
    return out




def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=2, choices=(2, 4))
    ap.add_argument("--blocks", type=int, default=23)
    ap.add_argument("--feat", type=int, default=64)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--staged", type=int, default=100,
                    help="optimizer steps per call of the staged loop")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hr-size", type=int, default=128)
    ap.add_argument("--patches", type=int, default=3072)
    ap.add_argument("--holdout", type=int, default=3,
                    help="images excluded from patch sampling, used for PSNR eval")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--usm", type=float, default=0.0,
                    help="USM-sharpen HR targets with this weight "
                         "(Real-ESRGAN's GT sharpening; try 0.5 at x4)")
    ap.add_argument("--gan-steps", type=int, default=0,
                    help="adversarial fine-tune steps after (or instead of) "
                         "the L1 phase — Real-ESRGAN's GAN arm (train/sr_gan.py)")
    ap.add_argument("--gan-adv-weight", type=float, default=0.1)
    ap.add_argument("--gan-percep-weight", type=float, default=0.0,
                    help="LPIPS-style feature-distance weight from the golden "
                         "YOLO backbone (train/perceptual.py; Real-ESRGAN "
                         "uses 1.0 for its VGG term)")
    ap.add_argument("--percep-from", default=None,
                    help="feature-extractor checkpoint (default: the "
                         "committed golden YOLO)")
    ap.add_argument("--gan-lr", type=float, default=1e-4)
    ap.add_argument("--init-from", default=None,
                    help="warm-start G from this .npz (skips the L1 phase "
                         "when --steps 0)")
    ap.add_argument("--max-crops", type=int, default=96)
    ap.add_argument("--out", default=None, help="checkpoint path (.npz)")
    ap.add_argument("--report", default=None, help="report path (.json)")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training; evaluate --out checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--goldens", default=GOLDENS_PATH)
    ap.add_argument("--ref-dir", default=REF_DIR)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs here)")
    args = ap.parse_args(argv)

    from facedet_tpu_torch.engine.detector import resolve_device, save_params_npz
    from facedet_tpu_torch.engine.enhancer import FaceEnhancer
    from facedet_tpu_torch.models.from_jax import load_rrdb_npz, to_jax_variables
    from facedet_tpu_torch.models.rrdbnet import RRDBConfig, RRDBNet, init_rrdbnet_
    from facedet_tpu_torch.train.sr_train import build_sr_dataset, make_sr_staged_loop
    from facedet_tpu_torch.train.yolo_train import ClippedAdamW, WarmupCosineDecay

    device = resolve_device(args.device)
    out_dir = os.path.join("runs", "sr_golden_train")
    ckpt = args.out or os.path.join(out_dir, f"rrdb_x{args.scale}_golden.npz")
    report_path = args.report or os.path.join(out_dir, "sr_report.json")

    records = load_unique_golden_images(ref_dir=args.ref_dir, goldens=args.goldens)
    print(f"golden corpus: {len(records)} unique scenes")
    # deterministic holdout: the largest images make the best fidelity probes
    order = sorted(range(len(records)),
                   key=lambda i: -records[i]["image"].size)
    hold_idx = set(order[1 : 1 + args.holdout])  # keep the biggest for training
    train_recs = [r for i, r in enumerate(records) if i not in hold_idx]
    holdout = [records[i] for i in sorted(hold_idx)]
    print("holdout:", [r["name"] for r in holdout])

    cfg = RRDBConfig(scale=args.scale, num_block=args.blocks,
                     num_feat=args.feat, dtype="float32")
    report = {}
    if args.eval_only and os.path.exists(report_path):
        with open(report_path) as f:
            report = json.load(f)  # keep the training provenance fields
    report.update({
        "config": {
            "scale": args.scale, "num_block": args.blocks, "num_feat": args.feat,
            "steps": args.steps, "batch": args.batch, "hr_size": args.hr_size,
            "patches": args.patches, "lr": args.lr, "seed": args.seed,
            "usm_weight": args.usm,
            "train_images": [r["name"] for r in train_recs],
            "holdout_images": [r["name"] for r in holdout],
        },
    })

    if not args.eval_only:
        t0 = time.time()
        lr_u8, hr_u8 = build_sr_dataset(
            [r["image"] for r in train_recs],
            args.patches, args.hr_size, args.scale, seed=args.seed,
            face_boxes=[np.asarray(r["boxes"]) for r in train_recs],
            usm_weight=args.usm,
        )
        n_batches = args.patches // args.batch
        lr_staged = lr_u8[: n_batches * args.batch].reshape(
            n_batches, args.batch, *lr_u8.shape[1:]
        )
        hr_staged = hr_u8[: n_batches * args.batch].reshape(
            n_batches, args.batch, *hr_u8.shape[1:]
        )
        print(f"dataset: {args.patches} patches "
              f"({(lr_staged.nbytes + hr_staged.nbytes) / 1e6:.0f} MB) "
              f"in {time.time() - t0:.0f}s")

        model = RRDBNet(cfg)
        if args.init_from:
            load_rrdb_npz(model, args.init_from)
            print(f"warm-start G from {args.init_from}")
        else:
            init_rrdbnet_(model, torch.Generator().manual_seed(args.seed))
        model = model.to(device)
        ema = copy.deepcopy(model)
        lr_d = torch.from_numpy(lr_staged).to(device)
        hr_d = torch.from_numpy(hr_staged).to(device)

        if args.steps > 0:
            sched = WarmupCosineDecay(args.lr, 200, max(args.steps, 201), args.lr * 0.05)
            tx = ClippedAdamW(model.parameters(), sched, weight_decay=0.0, max_norm=5.0)
            run = make_sr_staged_loop(model, tx, steps_per_dispatch=args.staged, seed=args.seed + 1)
            t0 = time.time()
            done = 0
            history = []
            while done < args.steps:
                loss = float(run(ema, lr_d, hr_d, start=done))
                done += args.staged  # the loop runs whole calls; overshoot is fine
                history.append((done, loss, round(time.time() - t0, 3)))
                print(f"step {min(done, args.steps)}/{args.steps} "
                      f"loss {loss:.4f} ({time.time() - t0:.0f}s)", flush=True)
            train_s = time.time() - t0
            report["train_seconds"] = round(train_s, 1)
            report["final_loss"] = round(loss, 5)
            report["loss_history"] = history

        if args.gan_steps > 0:
            from facedet_tpu_torch.train.sr_gan import (
                create_discriminator, make_sr_gan_staged_loop,
            )

            d_model = create_discriminator(64, seed=args.seed + 7).to(device)
            g_tx = ClippedAdamW(model.parameters(), lambda c: args.gan_lr, weight_decay=0.0, max_norm=5.0)
            d_tx = ClippedAdamW(d_model.parameters(), lambda c: args.gan_lr, weight_decay=0.0, max_norm=5.0)
            # the GAN phase re-seeds the EMA from the L1 solution: the
            # adversarial walk is what is averaged, not the L1 trajectory
            ema = copy.deepcopy(model)
            percep_fn = None
            if args.gan_percep_weight > 0:
                from facedet_tpu_torch.train.perceptual import (
                    GOLDEN_YOLO, make_yolo_feature_loss,
                )

                percep_fn = make_yolo_feature_loss(args.percep_from or GOLDEN_YOLO, device=device)
                print(f"perceptual term: golden YOLO features x "
                      f"{args.gan_percep_weight}")
            gan_run = make_sr_gan_staged_loop(
                model, d_model, g_tx, d_tx,
                steps_per_dispatch=args.staged,
                adv_weight=args.gan_adv_weight,
                percep_fn=percep_fn,
                percep_weight=args.gan_percep_weight,
                seed=args.seed + 2,
            )
            t0 = time.time()
            done = 0
            report["gan"] = {"steps": args.gan_steps,
                             "adv_weight": args.gan_adv_weight,
                             "percep_weight": args.gan_percep_weight,
                             "lr": args.gan_lr}
            while done < args.gan_steps:
                metrics = {k: float(v) for k, v in gan_run(ema, lr_d, hr_d, start=done).items()}
                done += args.staged
                print(f"gan step {min(done, args.gan_steps)}/{args.gan_steps} "
                      f"pixel {metrics['pixel']:.4f} "
                      f"adv {metrics['adv']:.4f} "
                      f"percep {metrics['percep']:.4f} "
                      f"d {metrics['d']:.4f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
            report["gan"]["seconds"] = round(time.time() - t0, 1)
            report["gan"]["final"] = {k: round(v, 5) for k, v in metrics.items()}

        save_params_npz(ckpt, to_jax_variables(ema.state_dict()), half=True)
        print(f"checkpoint -> {ckpt}")

    # ---- evaluation with the checkpoint ----
    enhancer = FaceEnhancer(
        model_name=f"rrdb_x{args.scale}_golden", model_path=ckpt,
        outscale=args.scale, cfg=RRDBConfig(
            scale=args.scale, num_block=args.blocks, num_feat=args.feat,
            dtype="bfloat16",
        ), device=device,
    )
    print("fidelity eval (held-out, degrade->restore PSNR)...")
    fid = fidelity_eval(enhancer, holdout, args.scale)
    report["fidelity_holdout"] = fid
    for row in fid:
        print(f"  {row['image']}: bicubic {row['psnr_bicubic']:.2f} dB "
              f"-> restored {row['psnr_restored']:.2f} dB")

    print("perceptual eval (real face crops, IQA before/after)...")
    crops = collect_face_crops(records, args.max_crops)
    enhanced = enhance_crops(enhancer, [c["crop"] for c in crops])
    report["iqa_face_crops"] = iqa_table(crops, enhanced)
    # custom --report names get their own side-by-side (a sr_x4gan report
    # must not clobber the sr_x4 grid)
    if args.report:
        stem = os.path.splitext(os.path.basename(report_path))[0]
        sbs_name = stem.replace("_report", "") + "_side_by_side.jpg"
    else:
        sbs_name = f"sr_x{args.scale}_side_by_side.jpg"
    os.makedirs(os.path.dirname(os.path.abspath(report_path)), exist_ok=True)
    sbs = os.path.join(os.path.dirname(report_path), sbs_name)
    report["side_by_side"] = save_side_by_side(crops, enhanced, sbs)
    print(f"side-by-side -> {sbs}")
    ov = report["iqa_face_crops"]["overall"]
    print(f"  n={ov['n']}  NIQE {ov['niqe_orig']:.3f}->{ov['niqe_enhanced']:.3f}"
          f"  BRISQUE {ov['brisque_orig']:.3f}->{ov['brisque_enhanced']:.3f}"
          f"  TOPIQ {ov['topiq_face_orig']:.3f}->{ov['topiq_face_enhanced']:.3f}")

    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"report -> {report_path}")
    return report


if __name__ == "__main__":
    main()
