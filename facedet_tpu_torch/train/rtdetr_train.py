"""RT-DETR training: matchers, DETR losses with contrastive denoising (CDN),
the train step, the staged loop and the trainer.

Counterpart of facedet_tpu/train/rtdetr_train.py, in plain torch ops and
autograd (the reference's pipeline_v3_RTDETR/train_rtdetr.py:162-241:
AdamW lr 1e-4, batch 8, imgsz 640, patience 10, save_period 5).

Parity with the JAX module:

* the matchers run batched over images: ``hungarian_match`` is scipy on the
  host (one device-to-host copy per decoder layer where the cost lies on
  the card), ``greedy_match`` takes ``min(Q, M)`` first-index ``argmin``s
  of the flattened cost, ``sinkhorn_match`` runs the same 300 log-domain
  iterations and greedy extraction; ``match_assignments("auto")`` reads the
  cost's device: Hungarian on the CPU, greedy on the card;
* random draws are inputs: the CDN noise ``part`` [B, G, 2, M, 4] (uniform
  in [0, 1)) and ``sign`` (+-1), the staged loop's flips [steps, B]; by
  default they come from a seeded ``torch.Generator``;
* ``.at[a].max(valid)`` is ``scatter_reduce(..., "amax",
  include_self=True)``; ``jnp.clip(x, 0)`` is ``torch.maximum`` (its tie
  gradient); the loss normalisers count over the whole batch;
* the optimizer is train/yolo_train.ClippedAdamW: the global-norm clip at
  0.1, then AdamW with weight decay 1e-4 on every parameter, lr 0 at count
  0 for both schedules (``WarmupCosineDecay`` and ``WarmupConstant``).
"""
from __future__ import annotations

import copy
import json
import math
import os
from typing import Iterable, Optional

import numpy as np
import torch

from facedet_tpu_torch.engine.detector import resolve_device, save_params_npz
from facedet_tpu_torch.models.from_jax import attention_heads, load_jax_variables, to_jax_variables
from facedet_tpu_torch.models.init import random_init
from facedet_tpu_torch.models.rtdetr import RtDetr, RtDetrConfig
from facedet_tpu_torch.train.yolo_train import ClippedAdamW, WarmupCosineDecay, _relu0, train_forward

__all__ = [
    "hungarian_match",
    "greedy_match",
    "sinkhorn_match",
    "match_assignments",
    "layer_assignments",
    "xyxy_to_cxcywh",
    "build_cdn",
    "rtdetr_loss",
    "train_loss",
    "WarmupConstant",
    "make_rtdetr_train_step",
    "make_staged_rtdetr_loop",
    "RtDetrTrainer",
]


def _hungarian_host(cost: np.ndarray) -> np.ndarray:
    """cost [Q, M] -> assignment [M] (query index per GT slot; -1 invalid)."""
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(cost)
    out = np.full((cost.shape[1],), -1, np.int32)
    out[cols] = rows.astype(np.int32)
    return out


def hungarian_match(cost: torch.Tensor) -> torch.Tensor:
    """Batched [B, Q, M] cost -> [B, M] assigned query index per GT (scipy
    on the host)."""
    host = cost.detach().to("cpu", torch.float32).numpy()
    return torch.from_numpy(np.stack([_hungarian_host(c) for c in host])).to(cost.device, torch.long)


def _greedy(cost: torch.Tensor) -> torch.Tensor:
    """Repeatedly take the smallest remaining pair (the first index on
    ties) and strike its row and column: [B, Q, M] -> [B, M]."""
    b, q, m = cost.shape
    cm = cost.clone()
    assign = torch.full((b, m), -1, dtype=torch.long, device=cost.device)
    rows = torch.arange(b, device=cost.device)
    for _ in range(min(q, m)):
        flat = cm.reshape(b, -1).argmin(1)
        qi, mi = flat // m, flat % m
        assign[rows, mi] = qi
        cm[rows, qi, :] = math.inf
        cm[rows, :, mi] = math.inf
    return assign


def greedy_match(cost: torch.Tensor) -> torch.Tensor:
    """Greedy bipartite matching on the device: [B, Q, M] -> [B, M]."""
    return _greedy(cost.detach())


def sinkhorn_match(
    cost: torch.Tensor, eps: float = 0.01, iters: int = 300, col_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Near-Hungarian matching by entropic optimal transport: the cost,
    padded to square with slack columns at the mean real cost (dead columns
    of ``col_mask`` become slack too), ``iters`` log-domain Sinkhorn
    iterations at temperature ``eps * std(real costs)``, then greedy
    extraction on the negated log-plan. [B, Q, M] -> [B, M]."""
    cost = cost.detach()
    b, q, m = cost.shape
    if col_mask is None:
        col_mask = torch.ones((b, m), dtype=torch.bool, device=cost.device)
    w = col_mask.to(cost.dtype)[:, None, :]
    denom = torch.clamp(w.sum((1, 2)) * q, min=1.0)
    mean_real = (cost * w).sum((1, 2)) / denom
    var_real = (((cost - mean_real[:, None, None]) ** 2) * w).sum((1, 2)) / denom
    scale = torch.clamp(torch.sqrt(var_real), min=1e-6)
    cs = torch.where(col_mask[:, None, :], cost, mean_real[:, None, None])
    if q > m:
        cs = torch.cat([cs, mean_real[:, None, None].expand(b, q, q - m)], 2)
    n = cs.shape[2]
    log_k = -cs / (eps * scale[:, None, None])
    log_mu = -torch.log(torch.tensor(float(q), device=cost.device))
    log_nu = -torch.log(torch.tensor(float(n), device=cost.device))
    u = torch.zeros((b, q), device=cost.device)
    v = torch.zeros((b, n), device=cost.device)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(log_k + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(log_k + u[:, :, None], dim=1)
    log_plan = (log_k + u[:, :, None] + v[:, None, :])[:, :, :m]
    return _greedy(-log_plan)


def match_assignments(cost: torch.Tensor, matcher="auto", col_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """'hungarian' (scipy on the host), 'greedy' or 'sinkhorn' (on the
    cost's device), or 'auto': Hungarian for a cost on the CPU, greedy on
    the card (no host round trip; the JAX module's rule by platform). A
    callable ``cost -> [B, M]`` gives the assignments itself (to hold two
    runs to one matching where their costs tie within rounding)."""
    if callable(matcher):
        return matcher(cost)
    if matcher == "auto":
        matcher = "hungarian" if cost.device.type == "cpu" else "greedy"
    if matcher == "hungarian":
        return hungarian_match(cost)
    if matcher == "sinkhorn":
        return sinkhorn_match(cost, col_mask=col_mask)
    if matcher == "greedy":
        return greedy_match(cost)
    raise ValueError(f"unknown matcher {matcher!r}")


def _cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_cxcywh(boxes: torch.Tensor, size: float) -> torch.Tensor:
    """Pixel xyxy boxes [..., 4] on a ``size``-square image -> the
    normalised cxcywh GT that the loss takes."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2 / size, (y1 + y2) / 2 / size, (x2 - x1) / size, (y2 - y1) / size], -1)


def _giou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Generalized IoU between xyxy box sets that broadcast [..., 4]."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = _relu0(rb - lt)
    inter = wh[..., 0] * wh[..., 1]
    area_a = _relu0(a[..., 2] - a[..., 0]) * _relu0(a[..., 3] - a[..., 1])
    area_b = _relu0(b[..., 2] - b[..., 0]) * _relu0(b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    iou = inter / (union + eps)
    elt = torch.minimum(a[..., :2], b[..., :2])
    erb = torch.maximum(a[..., 2:], b[..., 2:])
    ewh = _relu0(erb - elt)
    enclose = ewh[..., 0] * ewh[..., 1]
    return iou - (enclose - union) / (enclose + eps)


def _focal(p: torch.Tensor, tgt: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss per element on probabilities ``p``."""
    ce = -(tgt * torch.log(p + 1e-8) + (1 - tgt) * torch.log(1 - p + 1e-8))
    pt = tgt * p + (1 - tgt) * (1 - p)
    return ce * ((1 - pt) ** gamma) * (tgt * alpha + (1 - tgt) * (1 - alpha))


def layer_assignments(logits, boxes, gt_boxes, gt_mask, matcher="auto") -> torch.Tensor:
    """One decoder layer's matching: the cost ``-2 p + 5 L1 - 2 GIoU``
    [B, Q, M] (dead GT columns 1e6), matched without gradient -> [B, M]."""
    with torch.no_grad():
        cost_cls = -torch.sigmoid(logits)[..., 0:1]
        l1 = (boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
        giou = _giou(_cxcywh_to_xyxy(boxes)[:, :, None, :], _cxcywh_to_xyxy(gt_boxes)[:, None, :, :])
        cost = cost_cls * 2.0 + l1 * 5.0 - giou * 2.0
        cost = torch.where(gt_mask[:, None, :], cost, 1e6)
    return match_assignments(cost, matcher=matcher, col_mask=gt_mask)


def _layer_loss(logits, boxes, gt_boxes, gt_mask, cls_weight, box_weight, giou_weight, matcher="auto"):
    """One decoder layer's matched loss; gt_boxes cxcywh normalised [B,M,4]."""
    b, q, _ = logits.shape
    assign = layer_assignments(logits, boxes, gt_boxes, gt_mask, matcher)
    valid = gt_mask & (assign >= 0)
    a_safe = assign.clamp(min=0)
    n_valid = valid.sum().clamp(min=1)
    sel_boxes = torch.gather(boxes, 1, a_safe[..., None].expand(-1, -1, 4))
    l1_loss = ((sel_boxes - gt_boxes).abs().sum(-1) * valid).sum() / n_valid
    giou_loss = ((1.0 - _giou(_cxcywh_to_xyxy(sel_boxes), _cxcywh_to_xyxy(gt_boxes))) * valid).sum() / n_valid
    # matched queries -> 1, the rest -> 0; a padded slot at query 0 never clears a match
    tgt = torch.zeros((b, q), device=logits.device).scatter_reduce(
        1, a_safe, valid.float(), reduce="amax", include_self=True
    )
    cls_loss = _focal(torch.sigmoid(logits[..., 0]), tgt).sum() / n_valid
    total = cls_weight * cls_loss + box_weight * l1_loss + giou_weight * giou_loss
    return total, {"cls": cls_loss, "l1": l1_loss, "giou": giou_loss}


def _is_pos(m: int, num_groups: int, device) -> torch.Tensor:
    """[1, N]: the group-major layout ``[g0: pos(M) neg(M), g1: ...]``."""
    one = torch.cat([torch.ones(m, dtype=torch.bool), torch.zeros(m, dtype=torch.bool)])
    return one.repeat(num_groups)[None].to(device)


def build_cdn(
    gt_boxes: torch.Tensor,  # [B, M, 4] cxcywh normalised
    gt_mask: torch.Tensor,  # [B, M]
    num_groups: int = 5,
    box_noise_scale: float = 1.0,
    num_classes: int = 1,
    part: Optional[torch.Tensor] = None,
    sign: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Contrastive-denoising queries: per group a positive (GT box, small
    noise, its class) and a negative (larger noise, background =
    ``num_classes``) per GT slot. ``part`` [B, G, 2, M, 4] in [0, 1) and
    ``sign`` (+-1, same shape) are the noise draws (JAX's ``uniform`` and
    ``rademacher`` from the key); missing ones come from ``generator``.
    Returns (dn_labels [B, N], dn_ref [B, N, 4], positive mask [B, N]),
    N = 2 * num_groups * M."""
    b, m, _ = gt_boxes.shape
    shape = (b, num_groups, 2, m, 4)
    if part is None:
        part = torch.rand(shape, generator=generator)
    if sign is None:
        sign = torch.randint(0, 2, shape, generator=generator) * 2 - 1
    part = torch.as_tensor(part).to(gt_boxes.device, torch.float32)
    sign = torch.as_tensor(sign).to(gt_boxes.device, torch.float32)
    diff = torch.cat([gt_boxes[..., 2:] / 2, gt_boxes[..., 2:]], -1)
    # positives in [0, 1), negatives in [1, 2) x (scale * diff)
    part = part + torch.tensor([0.0, 1.0], device=gt_boxes.device)[None, None, :, None, None]
    noised = gt_boxes[:, None, None] + sign * part * diff[:, None, None] * box_noise_scale
    cxcy = noised[..., 0:2].clamp(0.0, 1.0)
    wh = noised[..., 2:4].clamp(1e-4, 1.0)
    dn_ref = torch.cat([cxcy, wh], -1).reshape(b, num_groups * 2 * m, 4)
    pos = _is_pos(m, num_groups, gt_boxes.device) & gt_mask.bool().repeat(1, num_groups * 2)
    dn_labels = torch.where(pos, 0, num_classes)
    return dn_labels, dn_ref, pos


def _dn_layer_loss(logits, boxes, gt_boxes, gt_mask, num_groups, cls_weight, box_weight, giou_weight):
    """Denoising loss with the positional (known) assignments."""
    m = gt_boxes.shape[1]
    tiled_gt = gt_boxes.repeat(1, num_groups * 2, 1)  # slot j <-> gt j % m
    valid = gt_mask.repeat(1, num_groups * 2)
    pos = _is_pos(m, num_groups, logits.device) & valid
    npos = pos.sum().clamp(min=1)
    l1_loss = ((boxes - tiled_gt).abs().sum(-1) * pos).sum() / npos
    giou_loss = ((1.0 - _giou(_cxcywh_to_xyxy(boxes), _cxcywh_to_xyxy(tiled_gt))) * pos).sum() / npos
    focal = _focal(torch.sigmoid(logits[..., 0]), pos.float())
    # padded-slot negatives carry no signal either way
    cls_loss = (focal * valid).sum() / npos
    return cls_weight * cls_loss + box_weight * l1_loss + giou_weight * giou_loss


def rtdetr_loss(
    outputs: dict,
    gt_boxes: torch.Tensor,  # [B, M, 4] cxcywh normalised to [0, 1]
    gt_mask: torch.Tensor,  # [B, M]
    cls_weight: float = 1.0,
    box_weight: float = 5.0,
    giou_weight: float = 2.0,
    dn_groups: int = 0,
    matcher="auto",
):
    """The mean over decoder layers of the matched losses (DETR's aux-loss
    scheme), plus the mean per-layer CDN loss when the forward carried
    denoising queries. Returns (total, parts): the last layer's cls / l1 /
    giou and ``dn``."""
    gt_mask = gt_mask.bool()
    total, parts = 0.0, {}
    n_layers = len(outputs["logits"])
    for li, (logits, boxes) in enumerate(zip(outputs["logits"], outputs["boxes"])):
        ll, p = _layer_loss(logits, boxes, gt_boxes, gt_mask, cls_weight, box_weight, giou_weight, matcher)
        total = total + ll
        if li == n_layers - 1:
            parts = p
    total = total / n_layers
    if "dn_logits" in outputs and dn_groups:
        dn_total = 0.0
        for logits, boxes in zip(outputs["dn_logits"], outputs["dn_boxes"]):
            dn_total = dn_total + _dn_layer_loss(
                logits, boxes, gt_boxes, gt_mask, dn_groups, cls_weight, box_weight, giou_weight
            )
        dn_total = dn_total / len(outputs["dn_logits"])
        parts = dict(parts, dn=dn_total)
        total = total + dn_total
    return total, parts


def train_loss(model, images, gt_boxes, gt_mask, dn_groups: int = 5, box_noise_scale: float = 1.0,
               part=None, sign=None, generator=None, matcher="auto", top_idx=None):
    """Train-mode forward with CDN queries (``dn_groups > 0``) and the loss:
    (total, parts, outputs), differentiable. ``top_idx`` fixes the query
    selection (models/rtdetr.RtDetr)."""
    kwargs = {"top_idx": top_idx}
    if dn_groups:
        dn_labels, dn_ref, _ = build_cdn(gt_boxes, gt_mask, dn_groups, box_noise_scale, model.cfg.num_classes,
                                         part, sign, generator)
        kwargs.update(dn_labels=dn_labels, dn_ref=dn_ref, dn_groups=dn_groups)
    outs = train_forward(model, images, **kwargs)
    total, parts = rtdetr_loss(outs, gt_boxes, gt_mask, dn_groups=dn_groups, matcher=matcher)
    return total, parts, outs


class WarmupConstant:
    """``optax.join_schedules([linear_schedule(0.0, peak_value, warmup_steps),
    constant_schedule(peak_value)], [warmup_steps])`` as a picklable
    ``count -> value``: 0 at count 0, the peak from ``warmup_steps`` on."""

    def __init__(self, peak_value: float, warmup_steps: int):
        self.peak_value, self.warmup_steps = float(peak_value), int(warmup_steps)

    def __call__(self, count: int) -> float:
        if count < self.warmup_steps:
            frac = 1 - max(count, 0) / self.warmup_steps
            return -self.peak_value * frac + self.peak_value
        return self.peak_value


def make_rtdetr_train_step(model: RtDetr, tx, dn_groups: int = 5, box_noise_scale: float = 1.0, seed: int = 0):
    """``step(images [B,H,W,3] in [0,1], gt_boxes [B,M,4] cxcywh normalised,
    gt_mask [B,M], part=None, sign=None) -> (loss, parts)``: the train-mode
    forward with ``dn_groups`` CDN groups (their noise ``part`` / ``sign``
    given, else drawn from a ``torch.Generator`` seeded with ``seed``), the
    loss (matcher 'auto'), ``backward`` and ``tx.step()``. The batch moves
    to the model's device; the results stay there."""
    device = next(model.parameters()).device
    gen = torch.Generator().manual_seed(seed)

    def step(images, gt_boxes, gt_mask, part=None, sign=None):
        tx.zero_grad()
        to = lambda t: torch.as_tensor(t).to(device)  # noqa: E731
        total, parts, _ = train_loss(model, to(images), to(gt_boxes), to(gt_mask).bool(), dn_groups,
                                     box_noise_scale, part, sign, gen)
        total.backward()
        tx.step()
        return total.detach(), {k: v.detach() for k, v in parts.items()}

    return step


def make_staged_rtdetr_loop(model: RtDetr, tx, steps_per_dispatch: int = 50, dn_groups: int = 5,
                            box_noise_scale: float = 1.0, flip: bool = True, seed: int = 0):
    """Training over a staged dataset on the device: uint8 batches
    ``[N, B, H, W, 3]`` with normalised cxcywh GT ``[N, B, M, 4]`` and masks,
    ``steps_per_dispatch`` CDN steps per call of ``run(images_u8, gt_boxes,
    gt_mask, start=0, flips=None, parts=None, signs=None)``, batches taken
    round-robin from ``start``. Each step normalises, flips (cx -> 1 - cx)
    where ``flips`` [steps, B] says so, re-zeroes dead GT rows and runs
    ``make_rtdetr_train_step``'s step with ``parts[i]`` / ``signs[i]`` as its
    CDN noise. Missing draws come from generators seeded with ``seed``.
    Returns the call's mean loss, a device scalar. A plain Python loop."""
    step = make_rtdetr_train_step(model, tx, dn_groups, box_noise_scale, seed)
    gen = torch.Generator().manual_seed(seed)

    def run(images_u8, gt_boxes, gt_mask, start: int = 0, flips=None, parts=None, signs=None):
        n, b = images_u8.shape[:2]
        if flip:
            if flips is None:
                flips = torch.rand((steps_per_dispatch, b), generator=gen) < 0.5
            flips = torch.as_tensor(flips, dtype=torch.bool).to(images_u8.device)
        loss_sum = torch.zeros((), device=images_u8.device)
        for i in range(steps_per_dispatch):
            idx = (start + i) % n
            img = images_u8[idx].float() * (1.0 / 255.0)  # XLA's x / 255
            bx, mk = gt_boxes[idx], gt_mask[idx].bool()
            if flip:
                f = flips[i]
                img = torch.where(f[:, None, None, None], img.flip(2), img)
                bx = torch.where(f[:, None, None], torch.cat([1.0 - bx[..., :1], bx[..., 1:]], -1), bx)
            bx = bx * mk[..., None]  # dead rows: a flip would leave cx = 1
            total, _ = step(img, bx, mk, None if parts is None else parts[i], None if signs is None else signs[i])
            loss_sum = loss_sum + total
        return loss_sum / steps_per_dispatch

    return run


class RtDetrTrainer:
    """The trainer, with the reference's checkpoint policy (best / last
    / every ``save_period`` epochs, patience; train_rtdetr.py:211-224),
    checkpoints as flax ``.npz`` files and a results.json / results.csv
    rollup. Weights: flax ``variables`` when given, else a seeded random
    init; the model trains on ``device`` (None: the card; raises without one
    unless ``device="cpu"``) with float32 parameters. ``total_steps`` picks
    the warmup-cosine schedule (to 0.05 lr), else warmup then constant."""

    def __init__(
        self,
        cfg: RtDetrConfig,
        lr: float = 1e-4,
        weight_decay: float = 1e-4,
        output_dir: str = "runs/rtdetr",
        patience: int = 10,
        save_period: int = 5,
        image_size: int = 640,
        seed: int = 0,
        dn_groups: int = 5,
        warmup_steps: int = 100,
        total_steps: Optional[int] = None,
        device=None,
        variables: Optional[dict] = None,
    ):
        self.cfg = cfg
        self.image_size = image_size
        self.device = resolve_device(device)
        model = RtDetr(cfg)
        if variables is None:
            random_init(model, seed)
        else:
            load_jax_variables(model, variables)
        self.model = model.to(self.device)
        if total_steps:
            schedule = WarmupCosineDecay(lr, warmup_steps, total_steps, lr * 0.05)
        else:
            schedule = WarmupConstant(lr, warmup_steps)
        self.tx = ClippedAdamW(self.model.parameters(), schedule, weight_decay, max_norm=0.1)
        self.step_fn = make_rtdetr_train_step(self.model, self.tx, dn_groups=dn_groups, seed=seed + 1)
        self.output_dir = output_dir
        self.patience = patience
        self.save_period = save_period
        self.history: list[dict] = []
        self.best_loss = float("inf")
        self.epochs_without_improvement = 0

    def save_checkpoint(self, name: str):
        """``output_dir/name.npz`` in flax's layout (the JAX ``RtDetr``
        loads it)."""
        save_params_npz(os.path.join(self.output_dir, f"{name}.npz"),
                        to_jax_variables(self.model.state_dict(), attention_heads(self.model)))

    def train_epoch(self, batches: Iterable[tuple]) -> float:
        """One pass over ``(images, gt_boxes, gt_mask)`` batches: the mean loss."""
        losses = [float(self.step_fn(images, gt_boxes, gt_mask)[0]) for images, gt_boxes, gt_mask in batches]
        return float(np.mean(losses)) if losses else 0.0

    def fit(self, epoch_batches, num_epochs: int = 50, verbose: bool = True) -> dict:
        """``epoch_batches(epoch)`` yields (images, boxes, mask)."""
        for epoch in range(num_epochs):
            mean_loss = self.train_epoch(epoch_batches(epoch))
            self.history.append({"epoch": epoch, "train_loss": mean_loss})
            if verbose:
                print(f"epoch {epoch}: loss {mean_loss:.4f}")
            self.save_checkpoint("last")
            if self.save_period and (epoch + 1) % self.save_period == 0:
                self.save_checkpoint(f"epoch{epoch + 1}")
            if mean_loss < self.best_loss - 1e-6:
                self.best_loss = mean_loss
                self.epochs_without_improvement = 0
                self.save_checkpoint("best")
            else:
                self.epochs_without_improvement += 1
                if self.epochs_without_improvement >= self.patience:
                    if verbose:
                        print(f"early stop at epoch {epoch} (patience {self.patience})")
                    break
        os.makedirs(self.output_dir, exist_ok=True)
        with open(os.path.join(self.output_dir, "results.json"), "w") as f:
            json.dump(self.history, f, indent=2)
        with open(os.path.join(self.output_dir, "results.csv"), "w") as f:
            f.write("epoch,train_loss\n")
            for h in self.history:
                f.write(f"{h['epoch']},{h['train_loss']:.6f}\n")
        return {"best_loss": self.best_loss, "epochs": len(self.history)}

    def as_detection_model(self, confidence_threshold: float = 0.25):
        """An ``RtDetrDetectionModel`` on a copy of the current weights (cast
        to the config's dtype, eval mode), on the trainer's device."""
        from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel

        det = RtDetrDetectionModel(
            dtype=self.cfg.dtype,
            confidence_threshold=confidence_threshold,
            image_size=self.image_size,
            load_at_init=False,
            device=self.device,
        )
        det.cfg = self.cfg
        det.model = copy.deepcopy(self.model).set_dtypes().eval()
        return det

    def validate(self, dataset, image_loader, use_sahi: bool = False) -> dict:
        """COCO mAP validation -> {'map', 'map50', 'map75'} (the reference's
        validate_model, train_rtdetr.py:228-241)."""
        from facedet_tpu_torch.tools.misc import validate_detector

        return validate_detector(self.as_detection_model(), dataset, image_loader, use_sahi=use_sahi)
