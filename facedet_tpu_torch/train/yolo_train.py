"""YOLOv11(-pose) training: assigner, loss, optimizer, train step and the
staged loop.

Counterpart of facedet_tpu/train/yolo_train.py, in plain torch ops and
autograd. The per-image functions of the JAX module run under ``jax.vmap``;
here they take the batch axis directly, with the same arithmetic per image.

Parity with the JAX module:

* ``jnp.clip(x, 0)`` and ``jnp.maximum`` are ``torch.maximum``: at a tie the
  gradient splits 0.5 / 0.5 in both, where ``torch.clamp`` passes it whole;
* ``.at[idx].max`` is ``scatter_reduce(..., "amax", include_self=True)`` and
  fancy indexing / ``take_along_axis`` are ``gather``; ``argmin``/``argmax``
  take the first index on ties in both;
* ``stop_gradient`` is ``detach``; ``optax.sigmoid_binary_cross_entropy`` is
  ``binary_cross_entropy_with_logits`` (a gradient flows into the target, as
  in JAX, where the target depends on the prediction);
* ``make_optimizer`` is optax's chain transcribed: the global-norm clip
  scales by ``max_norm / norm`` only when ``norm >= max_norm`` (torch's
  ``clip_grad_norm_`` divides by ``norm + 1e-6``), AdamW decays every
  parameter, and the warmup-cosine schedule gives 0 at count 0, so the first
  step moves nothing;
* a bfloat16 config trains float32 parameters and casts the conv weights
  for each forward, as flax's ``param_dtype`` / ``dtype`` do
  (``YoloV11.set_dtypes`` casts the stored weights, for inference only).

The sharded train loops (``make_sharded_train_step``,
``make_sharded_staged_train_loop``) run SPMD, one process per device of a
(dp, tile) ``DeviceMesh``: the batch splits over ``dp``, the parameters are
FSDP-sharded over ``tile`` by FSDP2's ``fully_shard`` on the 2-D mesh (HSDP:
replicated over ``dp``) following ``parallel.sharding.fsdp_param_shardings``,
whose replicated (small) parameters FSDP2 leaves alone and whose gradients
are averaged here; the optimizer state lives on the shards. One sharded step
equals the single-device step on the global batch. The hazards:

* the train-mode BatchNorm statistics must be those of the global batch,
  as GSPMD takes them: ``shard_state`` makes the model's BatchNorms
  ``layers.GroupBatchNorm2d`` over the ``dp`` group
  (``layers.sync_batch_statistics_``), so the running statistics come out
  the same on every rank;
* FSDP2 sums a gradient over every rank of the mesh and divides by a
  factor. Ranks of one ``tile`` group hold the same images and so the same
  gradient, and the ``dp`` ranks' local losses are means over equal local
  batches: the sum is ``tile`` times the sum over ``dp``, and the factor
  that gives the global batch's gradient is ``dp * tile``, the mesh size.
  It is set explicitly, with sum-only collectives (gloo has no
  pre-multiplied sum), so that no version's default decides it; the
  replicated parameters' gradients are averaged over the whole mesh alike;
* ``clip_by_global_norm_`` takes the norm of the whole gradient: a sharded
  (DTensor) gradient contributes its local sum of squares reduced over its
  shard group, never one rank's shard alone;
* a DTensor's ``.sum()`` or ``.item()`` either communicates or reads the
  local value: the step reads only local tensors, and the loss it returns
  is the ``dp`` mean of the ranks' local means, the same on every rank;
* a bfloat16 config casts the weights FSDP2 all-gathers, not the shards:
  ``train_forward`` unshards the model before it takes the casts, and the
  BatchNorm parameters stay float32 as flax keeps them (a
  ``MixedPrecisionPolicy`` would cast those too).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from facedet_tpu_torch.models.yolov11 import REG_MAX, STRIDES

__all__ = [
    "tal_assign",
    "yolo_loss",
    "WarmupCosineDecay",
    "ClippedAdamW",
    "clip_by_global_norm_",
    "make_optimizer",
    "train_forward",
    "compute_loss",
    "make_train_step",
    "make_staged_train_loop",
    "make_sharded_train_step",
    "make_sharded_staged_train_loop",
]


def _flat_anchors(level_shapes: list[tuple[int, int]], device=None):
    """Anchor centres [A, 2] (px, half-cell offset) and strides [A]."""
    anchors, strides = [], []
    for (h, w), s in zip(level_shapes, STRIDES):
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * s
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * s
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        anchors.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
        strides.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(anchors), torch.cat(strides)


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``'s formula (``torch.hypot`` rounds otherwise)."""
    x, y = x.abs(), y.abs()
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    return torch.where(hi == 0, hi, hi * torch.sqrt(1 + torch.square(lo / safe)))


def _inside(anchors: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """[..., M, A]: anchor centre inside (or on the edge of) the GT box."""
    ax, ay = anchors[:, 0], anchors[:, 1]
    g = gt_boxes[..., :, None, :]
    return (ax >= g[..., 0]) & (ax <= g[..., 2]) & (ay >= g[..., 1]) & (ay <= g[..., 3])


def _assign(anchors, strides, gt_boxes, gt_mask):
    """One anchor per GT: the nearest anchor centre among those inside the
    box at a level whose stride suits the box (else the nearest overall).
    gt_boxes [..., M, 4] -> [..., M] anchor indices."""
    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5
    inside = _inside(anchors, gt_boxes)
    size = torch.maximum(gt_boxes[..., 2] - gt_boxes[..., 0], gt_boxes[..., 3] - gt_boxes[..., 1])
    ratio = size[..., None] / strides
    level_ok = (ratio >= 1.5) & (ratio < 12.0)
    dist = _hypot(anchors[:, 0] - cx[..., None], anchors[:, 1] - cy[..., None])
    cost = dist + torch.where(inside, 0.0, 1e6) + torch.where(level_ok, 0.0, 1e3)
    return cost.argmin(-1)


def _relu0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0)`` = ``jnp.maximum(0, x)``, with its tie gradient."""
    return torch.maximum(x, torch.zeros_like(x))


def _iou_xyxy(a, b, eps=1e-7):
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = _relu0(rb - lt)
    inter = wh[..., 0] * wh[..., 1]
    area_a = _relu0(a[..., 2] - a[..., 0]) * _relu0(a[..., 3] - a[..., 1])
    area_b = _relu0(b[..., 2] - b[..., 0]) * _relu0(b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + eps)


def tal_assign(
    anchors: torch.Tensor,  # [A, 2] centres (px)
    pred_boxes: torch.Tensor,  # [..., A, 4] decoded xyxy
    pred_scores: torch.Tensor,  # [..., A, C] sigmoid probabilities
    gt_boxes: torch.Tensor,  # [..., M, 4] xyxy
    gt_mask: torch.Tensor,  # [..., M]
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
):
    """Task-aligned assignment: per GT the top-k anchors inside the box by
    ``score^alpha * IoU^beta``; an anchor claimed by several GT goes to the
    one of highest IoU. Any leading batch axes.

    Returns (fg [..., A] bool, best_gt [..., A] index, norm_align [..., A]:
    the IoU-normalised alignment that is the cls target)."""
    a = anchors.shape[0]
    iou = _iou_xyxy(gt_boxes[..., :, None, :], pred_boxes[..., None, :, :])  # [..., M, A]
    score = pred_scores[..., None, :, 0]  # single class: [..., 1, A]
    align = (score**alpha) * (iou**beta)
    inside = _inside(anchors, gt_boxes) & gt_mask[..., None]
    align = torch.where(inside, align, 0.0)

    kth = torch.topk(align, min(topk, a), dim=-1).values[..., -1:]
    cand = inside & (align >= torch.clamp(kth, min=1e-12))

    iou_masked = torch.where(cand, iou, -1.0)
    best_gt = iou_masked.argmax(-2)  # [..., A]
    fg = iou_masked.amax(-2) >= 0.0
    max_align = align.amax(-1, keepdim=True)
    max_iou = torch.where(cand, iou, 0.0).amax(-1, keepdim=True)
    norm = align * max_iou / torch.clamp(max_align, min=1e-9)  # [..., M, A]
    norm_align = torch.where(fg, norm.gather(-2, best_gt.unsqueeze(-2)).squeeze(-2), 0.0)
    return fg, best_gt, norm_align


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, *rest], idx [B, K] -> x[b, idx[b]]: [B, K, *rest]."""
    index = idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(*idx.shape, *x.shape[2:])
    return x.gather(1, index)


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, labels, reduction="none")


def _dfl(box_lg: torch.Tensor, ltrb: torch.Tensor) -> torch.Tensor:
    """Two-hot cross entropy of the box logits [..., 4, REG_MAX] on target
    distances [..., 4] (cell units): [..., 4]."""
    ltrb = torch.clamp(ltrb, 0.0, REG_MAX - 1 - 1e-3)
    lo = torch.floor(ltrb)
    w_hi = ltrb - lo
    logp = F.log_softmax(box_lg, dim=-1)
    lo_i = lo.long()
    lp_lo = logp.gather(-1, lo_i[..., None])[..., 0]
    lp_hi = logp.gather(-1, torch.clamp(lo_i + 1, max=REG_MAX - 1)[..., None])[..., 0]
    return -((1 - w_hi) * lp_lo + w_hi * lp_hi)


def _decode(box_lg, anchor_xy, stride):
    """DFL expectation -> xyxy px: box_lg [..., 4, REG_MAX]."""
    proj = torch.arange(REG_MAX, dtype=torch.float32, device=box_lg.device)
    dist = (F.softmax(box_lg, dim=-1) * proj).sum(-1)
    ax, ay = anchor_xy[..., 0], anchor_xy[..., 1]
    return torch.stack(
        [ax - dist[..., 0] * stride, ay - dist[..., 1] * stride,
         ax + dist[..., 2] * stride, ay + dist[..., 3] * stride],
        dim=-1,
    )


def _ltrb(anchor_xy, stride, boxes):
    ax, ay = anchor_xy[..., 0], anchor_xy[..., 1]
    return torch.stack(
        [(ax - boxes[..., 0]) / stride, (ay - boxes[..., 1]) / stride,
         (boxes[..., 2] - ax) / stride, (boxes[..., 3] - ay) / stride],
        dim=-1,
    )


def _kpt_xy(kpt_lg, ax, ay, s):
    """Raw keypoint logits [..., K, 3] -> x, y px [..., K] each; the anchor
    centre and stride broadcast over K."""
    px = (kpt_lg[..., 0] * 2.0 + (ax / s - 0.5)) * s
    py = (kpt_lg[..., 1] * 2.0 + (ay / s - 0.5)) * s
    return px, py


def _tal_losses(anchors, strides, box_lg, cls_lg, boxes, mask, kpt_lg=None, kpts=None):
    """TAL multi-positive assignment over all anchors (the v8/v11 loss); each
    part per image, [B]."""
    nc = cls_lg.shape[-1]
    pred_boxes = _decode(box_lg, anchors, strides)  # [B, A, 4]
    pred_scores = torch.sigmoid(cls_lg)
    fg, best_gt, norm_align = tal_assign(anchors, pred_boxes.detach(), pred_scores.detach(), boxes, mask)
    tgt_boxes = _take_rows(boxes, best_gt)  # [B, A, 4]
    wsum = torch.clamp(norm_align.sum(-1), min=1.0)

    iou = _iou_xyxy(pred_boxes, tgt_boxes)
    box_l = torch.where(fg, (1.0 - iou) * norm_align, 0.0).sum(-1) / wsum
    dfl_all = _dfl(box_lg, _ltrb(anchors, strides, tgt_boxes))
    dfl = torch.where(fg, dfl_all.mean(-1) * norm_align, 0.0).sum(-1) / wsum
    # classification: target = normalised alignment at class 0
    tgt = torch.cat([norm_align[..., None], norm_align.new_zeros(norm_align.shape + (nc - 1,))], -1)
    cls_l = _bce(cls_lg, tgt).sum((-1, -2)) / wsum

    out = {"box": box_l, "cls": cls_l, "dfl": dfl}
    if kpt_lg is not None:
        tgt_kpts = _take_rows(kpts, best_gt)  # [B, A, K, 3]
        px, py = _kpt_xy(kpt_lg, anchors[:, 0, None], anchors[:, 1, None], strides[:, None])
        vis = (tgt_kpts[..., 2] > 0) & fg[..., None]
        kw = torch.clamp(vis.sum((-1, -2)), min=1)
        size = torch.clamp(tgt_boxes[..., 2] - tgt_boxes[..., 0], min=1.0)[..., None]
        kl = ((px - tgt_kpts[..., 0]).abs() + (py - tgt_kpts[..., 1]).abs()) / size
        out["kpt"] = (kl * vis).sum((-1, -2)) / kw
        out["kobj"] = (_bce(kpt_lg[..., 2], vis.float()) * fg[..., None]).sum((-1, -2)) / kw
    return out


def _nearest_losses(anchors, strides, box_lg, cls_lg, boxes, mask, kpt_lg=None, kpts=None):
    """One positive anchor per GT (``_assign``); each part per image, [B]."""
    b, a_total, nc = cls_lg.shape
    idx = _assign(anchors, strides, boxes, mask)  # [B, M]
    pos_anchor = anchors[idx]  # [B, M, 2]
    pos_stride = strides[idx]  # [B, M]
    n_live = torch.clamp(mask.sum(-1), min=1)
    live = mask.float()

    pos_lg = _take_rows(box_lg, idx)  # [B, M, 4, REG_MAX]
    dfl = _dfl(pos_lg, _ltrb(pos_anchor, pos_stride, boxes))
    dfl = (dfl.mean(-1) * mask).sum(-1) / n_live

    iou = _iou_xyxy(_decode(pos_lg, pos_anchor, pos_stride), boxes)
    box_l = ((1.0 - iou) * mask).sum(-1) / n_live

    # classification BCE over all anchors; the target is the IoU at the
    # positive anchor (the largest where two GT share one)
    tgt0 = torch.zeros((b, a_total), device=cls_lg.device).scatter_reduce(
        1, idx, live * _relu0(iou), reduce="amax", include_self=True
    )
    tgt = torch.cat([tgt0[..., None], tgt0.new_zeros((b, a_total, nc - 1))], -1)
    cls_l = _bce(cls_lg, tgt).sum((-1, -2)) / n_live

    out = {"box": box_l, "cls": cls_l, "dfl": dfl}
    if kpt_lg is not None:
        pk = _take_rows(kpt_lg, idx)  # [B, M, K, 3]
        px, py = _kpt_xy(pk, pos_anchor[..., 0, None], pos_anchor[..., 1, None], pos_stride[..., None])
        vis = kpts[..., 2] > 0
        wsum = torch.clamp((vis * mask[..., None]).sum((-1, -2)), min=1)
        size = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1.0)[..., None]
        kl = ((px - kpts[..., 0]).abs() + (py - kpts[..., 1]).abs()) / size
        out["kpt"] = (kl * vis * mask[..., None]).sum((-1, -2)) / wsum
        out["kobj"] = (_bce(pk[..., 2], vis.float()) * mask[..., None]).sum((-1, -2)) / wsum
    return out


def yolo_loss(
    level_outputs: list[dict],
    gt_boxes: torch.Tensor,  # [B, M, 4] xyxy pixels
    gt_mask: torch.Tensor,  # [B, M] bool
    gt_kpts: Optional[torch.Tensor] = None,  # [B, M, K, 3] (x, y, vis)
    box_weight: float = 7.5,
    cls_weight: float = 0.5,
    dfl_weight: float = 1.5,
    kpt_weight: float = 12.0,
    kobj_weight: float = 1.0,
    use_tal: bool = True,
) -> tuple[torch.Tensor, dict]:
    """Raw NHWC level maps (``YoloV11.forward``) and padded GT -> (total,
    parts): box IoU, BCE cls and DFL, and with keypoints their L1 and
    visibility BCE; each part is the mean over the batch of its per-image
    value."""
    level_shapes = [(lvl["box"].shape[1], lvl["box"].shape[2]) for lvl in level_outputs]
    anchors, strides = _flat_anchors(level_shapes, level_outputs[0]["box"].device)
    b = level_outputs[0]["box"].shape[0]
    nc = level_outputs[0]["cls"].shape[-1]
    box_lg = torch.cat([lvl["box"].reshape(b, -1, 4, REG_MAX) for lvl in level_outputs], 1)
    cls_lg = torch.cat([lvl["cls"].reshape(b, -1, nc) for lvl in level_outputs], 1)
    kpt_lg = None
    if gt_kpts is not None and "kpt" in level_outputs[0]:
        k = gt_kpts.shape[-2]
        kpt_lg = torch.cat([lvl["kpt"].reshape(b, -1, k, 3) for lvl in level_outputs], 1)

    fn = _tal_losses if use_tal else _nearest_losses
    losses = fn(anchors, strides, box_lg, cls_lg, gt_boxes, gt_mask.bool(),
                kpt_lg, gt_kpts if kpt_lg is not None else None)
    losses = {k: v.mean() for k, v in losses.items()}
    total = box_weight * losses["box"] + cls_weight * losses["cls"] + dfl_weight * losses["dfl"]
    if kpt_lg is not None:
        total = total + kpt_weight * losses["kpt"] + kobj_weight * losses["kobj"]
    return total, losses


class WarmupCosineDecay:
    """``optax.warmup_cosine_decay_schedule(0.0, peak_value, warmup_steps,
    decay_steps, end_value)`` as a picklable ``count -> value``: linear from 0
    to ``peak_value`` over ``warmup_steps``, then cosine down to
    ``end_value`` at ``decay_steps`` (the warmup included)."""

    def __init__(self, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0):
        if decay_steps - warmup_steps <= 0:
            raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")
        self.peak_value = float(peak_value)
        self.warmup_steps, self.decay_steps = int(warmup_steps), int(decay_steps)
        self.alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def __call__(self, count: int) -> float:
        if count < self.warmup_steps:
            frac = 1 - min(max(count, 0), self.warmup_steps) / self.warmup_steps
            return -self.peak_value * frac + self.peak_value
        span = self.decay_steps - self.warmup_steps
        t = min(count - self.warmup_steps, span)
        cosine = 0.5 * (1 + math.cos(math.pi * t / span))
        return self.peak_value * ((1 - self.alpha) * cosine + self.alpha)


def _is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _sharded_sq_norm(grads: list) -> torch.Tensor:
    """The squared norm of DTensor gradients: per set of shard dimensions,
    the local sums of squares summed over those mesh dimensions' groups."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    by_dims: dict[tuple, list] = {}
    for g in grads:
        dims = tuple(i for i, p in enumerate(g.placements) if isinstance(p, Shard))
        by_dims.setdefault((g.device_mesh, dims), []).append(g.to_local())
    total = None
    for (mesh, dims), local in by_dims.items():
        sq = torch.stack(torch._foreach_norm(local)).square().sum()
        for d in dims:
            dist.all_reduce(sq, group=mesh.get_group(d))
        total = sq if total is None else total + sq
    return total


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: below ``max_norm`` the
    gradients stay as they are, else each becomes ``g / norm * max_norm``.
    Returns the norm (a tensor: no host sync). DTensor gradients (FSDP
    shards) count with their whole tensor: their local sums of squares are
    reduced over their shard groups before the comparison."""
    sharded = [g for g in grads if _is_dtensor(g)]
    if not sharded:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    else:
        plain = [g for g in grads if not _is_dtensor(g)]
        sq = _sharded_sq_norm(sharded)
        if plain:
            sq = sq + torch.stack(torch._foreach_norm(plain)).square().sum()
        norm = torch.sqrt(sq)
        grads = plain + [g.to_local() for g in sharded]  # views: scaled in place
    below = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(below, one, norm))
    torch._foreach_mul_(grads, torch.where(below, one, one * max_norm))
    return norm


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay))``: every parameter in one group, so every one decays;
    eps 1e-8, betas (0.9, 0.999). ``step()`` clips, steps AdamW at the
    schedule's value for this count, then advances the count. A parameter
    that got no gradient gets zeros, as optax sees one."""

    def __init__(self, params, schedule: Callable[[int], float], weight_decay: float, max_norm: float = 10.0):
        self.params = list(params)
        fused = all(p.is_cuda for p in self.params) or None
        # FSDP shards (DTensors) and plain tensors go in separate groups of
        # the same settings: a foreach or fused step takes one kind per list
        groups = [
            {"params": ps}
            for ps in ([p for p in self.params if not _is_dtensor(p)], [p for p in self.params if _is_dtensor(p)])
            if ps
        ]
        # lr 1.0 times the schedule's factor is the schedule's value itself
        self.optimizer = torch.optim.AdamW(
            groups, lr=1.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay, fused=fused
        )
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, schedule)
        self.max_norm = max_norm

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_([p.grad for p in self.params], self.max_norm)
        self.optimizer.step()
        self.scheduler.step()


def make_optimizer(params, lr: float = 1e-4, weight_decay: float = 0.0005, warmup_steps: int = 100) -> ClippedAdamW:
    """AdamW with the JAX module's settings: global-norm clip at 10, a linear
    warmup from 0 over ``warmup_steps``, cosine decay to ``0.01 * lr`` at
    step 10,000."""
    sched = WarmupCosineDecay(lr, warmup_steps, 10_000, lr * 0.01)
    return ClippedAdamW(params, sched, weight_decay)


def _kernel_params(model: nn.Module):
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            for pname, p in m.named_parameters(recurse=False):
                yield f"{name}.{pname}" if name else pname, p


def train_forward(model: nn.Module, images: torch.Tensor, **kwargs):
    """The model in train mode on NHWC images (``kwargs`` go to its forward).
    With a bfloat16 config the conv and linear weights are cast for this call
    only, so the parameters (and the gradients the optimizer sees) stay
    float32."""
    model.train()
    dtype = model.cfg.compute_dtype
    if dtype == torch.float32:
        return model(images, **kwargs)
    from torch.distributed.fsdp import FSDPModule

    if isinstance(model, FSDPModule):
        # all-gather first, so the casts are of the whole weights; FSDP's
        # pre-forward then finds them gathered and leaves the casts in place
        model.unshard()
    casts = {}
    for name, p in _kernel_params(model):
        if _is_dtensor(p):
            raise RuntimeError(f"{name} is still a shard after unshard()")
        casts[name] = p.to(dtype)
    return torch.func.functional_call(model, casts, (images,), kwargs)


def _set_bn_dtype(model: nn.Module) -> None:
    """YOLO's ``ConvBnAct`` output dtype (flax's ``bn_dtype``), which
    ``set_dtypes`` would set with the weights' cast."""
    for m in model.modules():
        if hasattr(m, "bn_dtype"):
            m.bn_dtype = model.cfg.bn_compute_dtype


def compute_loss(model, images, gt_boxes, gt_mask, gt_kpts=None, loss: Optional[Callable] = None):
    """Train-mode forward and loss: (total, parts), differentiable."""
    return (loss or yolo_loss)(train_forward(model, images), gt_boxes, gt_mask, gt_kpts)


def make_train_step(model: nn.Module, tx, loss: Optional[Callable] = None):
    """``step(images [B,H,W,3] in [0,1], gt_boxes [B,M,4], gt_mask [B,M],
    gt_kpts [B,M,K,3] | None) -> (loss, parts)``: the model in train mode,
    the loss, ``backward``, then ``tx.step()`` (for ``make_optimizer``'s:
    clip, AdamW, schedule). ``tx`` is any object with ``zero_grad`` and
    ``step`` (a ``torch.optim`` optimizer too). The batch moves to the
    model's device; the results stay there (no host sync)."""
    device = next(model.parameters()).device
    _set_bn_dtype(model)

    def step(images, gt_boxes, gt_mask, gt_kpts=None):
        tx.zero_grad()
        to = lambda t: None if t is None else torch.as_tensor(t).to(device)  # noqa: E731
        total, parts = compute_loss(model, to(images), to(gt_boxes), to(gt_mask), to(gt_kpts), loss)
        total.backward()
        tx.step()
        return total.detach(), {k: v.detach() for k, v in parts.items()}

    return step


_FLIP_KPTS = [1, 0, 2, 4, 3]  # [l_eye, r_eye, nose, l_mouth, r_mouth] mirrored


def _staged_batch(images_u8, gt_boxes, gt_mask, gt_kpts, idx: int, flips: Optional[torch.Tensor]):
    """Batch ``idx`` of the staged arrays as the JAX loop body builds it:
    uint8 -> [0, 1] as XLA computes it, the per-sample h-flip where ``flips`` [B] says so
    (boxes mirrored, keypoint x mirrored and the five landmarks permuted
    left/right), then dead GT rows zeroed again."""
    img = images_u8[idx].float() * (1.0 / 255.0)  # XLA's x / 255: a multiply by the float32 reciprocal
    bx, mk, kp = gt_boxes[idx], gt_mask[idx], gt_kpts[idx]
    if flips is not None:
        width = images_u8.shape[3]
        img = torch.where(flips[:, None, None, None], img.flip(2), img)
        fb = torch.stack([width - bx[..., 2], bx[..., 1], width - bx[..., 0], bx[..., 3]], -1)
        bx = torch.where(flips[:, None, None], fb, bx)
        kpx = torch.cat([width - kp[..., :1], kp[..., 1:]], -1)
        if kp.shape[-2] == 5:
            kpx = kpx[..., _FLIP_KPTS, :]
        kp = torch.where(flips[:, None, None, None], kpx, kp)
    bx = bx * mk[..., None]
    kp = kp * mk[..., None, None]
    return img, bx, mk, kp


def make_staged_train_loop(
    model: nn.Module,
    tx,
    steps_per_dispatch: int = 100,
    flip: bool = True,
    loss: Optional[Callable] = None,
    seed: int = 0,
):
    """Training over a staged dataset on the device: uint8 batches
    ``[N, B, H, W, 3]`` with their GT, ``steps_per_dispatch`` steps per call
    of ``run(images_u8, gt_boxes, gt_mask, gt_kpts, start=0, flips=None)``,
    batches taken round-robin from ``start``. Each step normalises, flips
    (``flip=True``), re-zeroes dead rows and runs ``make_train_step``'s step.
    ``flips`` [steps, B] bool gives the flip draws (JAX's
    ``bernoulli(fold_in(key, i))`` in the tests); by default they come from a
    ``torch.Generator`` seeded with ``seed``. Returns the mean loss of the
    call, a device scalar. ``loss`` replaces ``yolo_loss`` (the SCRFD loop).
    A plain Python loop: with ``flip=False`` it is the stepwise run."""
    step = make_train_step(model, tx, loss)
    gen = torch.Generator().manual_seed(seed)

    def run(images_u8, gt_boxes, gt_mask, gt_kpts, start: int = 0, flips: Optional[torch.Tensor] = None):
        n, b = images_u8.shape[:2]
        if flip:
            if flips is None:
                flips = torch.rand((steps_per_dispatch, b), generator=gen) < 0.5
            flips = torch.as_tensor(flips, dtype=torch.bool).to(images_u8.device)
        loss_sum = torch.zeros((), device=images_u8.device)
        for i in range(steps_per_dispatch):
            batch = _staged_batch(images_u8, gt_boxes, gt_mask, gt_kpts, (start + i) % n,
                                  flips[i] if flip else None)
            total, _ = step(*batch)
            loss_sum = loss_sum + total
        return loss_sum / steps_per_dispatch

    return run


# --- sharded over a (dp, tile) mesh -------------------------------------------------


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _shard_model(model: nn.Module, mesh, fsdp_axis: str) -> list[nn.Parameter]:
    """FSDP2 over ``fsdp_axis`` with ``fsdp_param_shardings``'s plan: each
    planned parameter sharded on its dimension, the others left replicated
    (``ignored_params``). Returns the replicated parameters."""
    import torch.distributed as dist
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from facedet_tpu_torch.parallel.sharding import fsdp_param_shardings

    if tuple(mesh.mesh_dim_names) != ("dp", fsdp_axis):
        raise ValueError(f"the sharded step takes a ('dp', {fsdp_axis!r}) mesh, not {mesh.mesh_dim_names}")
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must hold every rank of the process group")
    model.to(_mesh_device(mesh))
    plan = fsdp_param_shardings(model, mesh, axis=fsdp_axis)
    dims = {}
    replicated = []
    for name, p in model.named_parameters():
        placement = plan[name][1]
        if isinstance(placement, Shard):
            dims[p] = placement.dim
        else:
            replicated.append(p)
    fully_shard(model, mesh=mesh, shard_placement_fn=lambda p: Shard(dims[p]), ignored_params=set(replicated))
    # plain sums on the wire, one division by the mesh size after them
    model.set_force_sum_reduction_for_comms(True)
    model.set_gradient_divide_factor(float(mesh.size()))
    return replicated


def _average_replicated_grads(params: list[nn.Parameter], world: int) -> None:
    """Mean of the replicated parameters' gradients over every rank, in one
    flat all-reduce: FSDP2's divisor for the sharded ones (module docstring)."""
    import torch.distributed as dist

    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset : offset + g.numel()].view_as(g)
        offset += g.numel()


def _sharded_step_fn(model: nn.Module, tx, mesh, fsdp_axis: str):
    """(local_step, shard_state): ``local_step`` takes this rank's share of a
    batch (already on the device) and returns the global (loss, parts)."""
    import torch.distributed as dist

    from facedet_tpu_torch.models import layers

    state: dict = {}

    def shard_state():
        state["replicated"] = _shard_model(model, mesh, fsdp_axis)
        # the module docstring's hazards: statistics over the global batch
        layers.sync_batch_statistics_(model, mesh.get_group("dp"))
        state["tx"] = tx(list(model.parameters()))
        _set_bn_dtype(model)
        return state["tx"]

    def local_step(images, gt_boxes, gt_mask, gt_kpts):
        if "tx" not in state:
            raise RuntimeError("call shard_state() before the first step")
        opt = state["tx"]
        opt.zero_grad()
        total, parts = compute_loss(model, images, gt_boxes, gt_mask, gt_kpts)
        total.backward()
        _average_replicated_grads(state["replicated"], mesh.size())
        opt.step()
        keys = list(parts)
        vals = torch.stack([total.detach()] + [parts[k].detach() for k in keys])
        dist.all_reduce(vals, group=mesh.get_group("dp"))
        vals = vals / mesh.size(0)
        return vals[0], dict(zip(keys, vals[1:]))

    return local_step, shard_state


def make_sharded_train_step(model: nn.Module, tx, mesh, fsdp_axis: str = "tile"):
    """Train step over a (dp, tile) mesh: the batch sharded over ``dp``,
    the parameters and the optimizer state FSDP-sharded over ``fsdp_axis``
    (module docstring). Returns ``(step, shard_state)``.

    ``shard_state()`` shards ``model`` in place and builds the optimizer
    ``tx(params)`` over the shards (``tx`` is a function of the parameter
    list, e.g. ``lambda ps: make_optimizer(ps, lr=1e-3)``: an optimizer needs
    the sharded parameters, which exist only then); it returns the
    optimizer. ``step(images [B,H,W,3], gt_boxes [B,M,4], gt_mask [B,M],
    gt_kpts [B,M,K,3] | None) -> (loss, parts)``: every rank passes the same
    global batch and takes its ``dp`` share; the loss and parts are those of
    the global batch, on every rank. A bfloat16 config trains as
    ``train_forward`` says: float32 parameters, gradients and optimizer
    state, the all-gathered conv and linear weights cast for each forward."""
    from facedet_tpu_torch.parallel.sharding import batch_sharding, local_shard

    local_step, shard_state = _sharded_step_fn(model, tx, mesh, fsdp_axis)
    device = _mesh_device(mesh)

    def step(images, gt_boxes, gt_mask, gt_kpts=None):
        place = batch_sharding(mesh, 4, "dp")
        share = lambda t: None if t is None else local_shard(torch.as_tensor(t), mesh, place).to(device)  # noqa: E731
        return local_step(share(images), share(gt_boxes), share(gt_mask), share(gt_kpts))

    return step, shard_state


def make_sharded_staged_train_loop(
    model: nn.Module,
    tx,
    mesh,
    steps_per_dispatch: int = 100,
    flip: bool = True,
    fsdp_axis: str = "tile",
    seed: int = 0,
):
    """``make_staged_train_loop`` over a (dp, tile) mesh. The staged arrays'
    batch axis (dim 1) and the flip draws' batch axis shard over ``dp``
    (``staged_sharding``); the stage axis replicates, so every rank walks the
    same round-robin schedule. Returns ``(run, shard_state)`` as
    ``make_sharded_train_step`` does; ``run(images_u8 [N,B,H,W,3], gt_boxes,
    gt_mask, gt_kpts, start=0, flips=None [steps, B])`` takes the global
    arrays on every rank and returns the mean loss of the call over the
    global batches. Default flips come from a ``torch.Generator`` seeded
    with ``seed``, drawn for the global batch."""
    from facedet_tpu_torch.parallel.sharding import local_shard, staged_sharding

    local_step, shard_state = _sharded_step_fn(model, tx, mesh, fsdp_axis)
    device = _mesh_device(mesh)
    gen = torch.Generator().manual_seed(seed)

    def run(images_u8, gt_boxes, gt_mask, gt_kpts, start: int = 0, flips: Optional[torch.Tensor] = None):
        place = staged_sharding(mesh, 5, "dp")
        share = lambda t: local_shard(torch.as_tensor(t), mesh, place).to(device)  # noqa: E731
        images_u8, gt_boxes, gt_mask, gt_kpts = (share(t) for t in (images_u8, gt_boxes, gt_mask, gt_kpts))
        n = images_u8.shape[0]
        if flip:
            if flips is None:
                b = images_u8.shape[1] * mesh.size(0)
                flips = torch.rand((steps_per_dispatch, b), generator=gen) < 0.5
            flips = share(torch.as_tensor(flips, dtype=torch.bool))
        loss_sum = torch.zeros((), device=device)
        for i in range(steps_per_dispatch):
            batch = _staged_batch(images_u8, gt_boxes, gt_mask, gt_kpts, (start + i) % n,
                                  flips[i] if flip else None)
            total, _ = local_step(*batch)
            loss_sum = loss_sum + total
        return loss_sum / steps_per_dispatch

    return run, shard_state
