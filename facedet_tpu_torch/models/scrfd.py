"""SCRFD-style anchor-based face detector as a PyTorch ``nn.Module``.

Counterpart of facedet_tpu/models/scrfd.py: a ResNet-like backbone with
stride 8/16/32 outputs, a PAFPN neck and a shared GroupNorm conv head with
three branches per level (class score, box as ltrb distances in stride
units, five keypoint offsets), two anchors per location. ``Scrfd.forward``
takes NHWC images in [0, 1] and returns per-level ``{"cls", "box", "kps"}``
maps in NHWC float32, as the flax module does; the convs run NCHW
(``forward_nchw``).

Submodules carry the flax names, the auto-named ones included
(``Conv_0``/``BatchNorm_0`` ... in creation order), so the committed
``scrfd_2_5g_golden.npz`` loads by name through models/from_jax.py.

Parity notes: BatchNorm eps is 1e-5 and GroupNorm eps 1e-6 (flax's
defaults), and in train mode BatchNorm is flax's (momentum 0.99,
``FlaxBatchNorm2d``); convs run in the config's dtype, the norms in float32,
and the head's maps are float32; the input is normalised ``(x*255 - 127.5)/128``
inside the model; the top-down upsample is cropped to the lateral's size,
which covers odd feature maps.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from facedet_tpu_torch.models.init import random_init
from facedet_tpu_torch.models.layers import FlaxBatchNorm2d, upsample2x

__all__ = [
    "STRIDES",
    "NUM_ANCHORS",
    "ScrfdConfig",
    "SCRFD_VARIANTS",
    "ResBlock",
    "ScrfdBackbone",
    "Pafpn",
    "ScrfdHead",
    "Scrfd",
    "decode_scrfd",
    "decode_scrfd_flat",
    "create_scrfd",
]

STRIDES = (8, 16, 32)
NUM_ANCHORS = 2  # anchors per location (same centre, duplicated)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ScrfdConfig:
    stem: int = 28
    widths: tuple[int, int, int, int] = (28, 56, 88, 128)
    depths: tuple[int, int, int, int] = (3, 4, 2, 3)
    neck: int = 56
    head_depth: int = 2
    head_width: int = 80
    num_keypoints: int = 5
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


# rough parameter-budget variants mirroring published SCRFD scales
SCRFD_VARIANTS = {
    "scrfd_500m": ScrfdConfig(stem=16, widths=(16, 32, 48, 96), depths=(2, 2, 2, 2), neck=32, head_width=48),
    "scrfd_2.5g": ScrfdConfig(),
    "scrfd_10g": ScrfdConfig(stem=56, widths=(56, 88, 136, 200), depths=(3, 5, 3, 3), neck=88, head_width=112),
}


def _conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A conv in its weight's dtype (flax's ``dtype``)."""
    return m(x.to(m.weight.dtype))


def _bn(m: FlaxBatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in float32, float32 out (flax's, momentum 0.99, in train mode)."""
    return m(x.float())


class ResBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, 3, stride=stride, padding=1, bias=False)
        self.BatchNorm_0 = FlaxBatchNorm2d(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.BatchNorm_1 = FlaxBatchNorm2d(features)
        self.project = cin != features or stride != 1
        if self.project:
            self.Conv_2 = nn.Conv2d(cin, features, 1, stride=stride, bias=False)
            self.BatchNorm_2 = FlaxBatchNorm2d(features)

    def forward(self, x):
        y = torch.relu(_bn(self.BatchNorm_0, _conv(self.Conv_0, x)))
        y = _bn(self.BatchNorm_1, _conv(self.Conv_1, y))
        if self.project:
            x = _bn(self.BatchNorm_2, _conv(self.Conv_2, x))
        return torch.relu(x + y)


class ScrfdBackbone(nn.Module):
    def __init__(self, cfg: ScrfdConfig):
        super().__init__()
        self.stem = nn.Conv2d(3, cfg.stem, 3, stride=2, padding=1, bias=False)
        self.stem_bn = FlaxBatchNorm2d(cfg.stem)
        self.blocks: list[list[str]] = []
        cin = cfg.stem
        for stage, (w, d) in enumerate(zip(cfg.widths, cfg.depths)):
            names = []
            for i in range(d):
                name = f"s{stage}_b{i}"
                setattr(self, name, ResBlock(cin, w, stride=2 if i == 0 else 1))
                names.append(name)
                cin = w
            self.blocks.append(names)

    def forward(self, x):
        x = torch.relu(_bn(self.stem_bn, _conv(self.stem, x)))
        outs = []
        for stage, names in enumerate(self.blocks):
            for name in names:
                x = getattr(self, name)(x)
            if stage >= 1:  # strides 8, 16, 32
                outs.append(x)
        return outs


class Pafpn(nn.Module):
    def __init__(self, cfg: ScrfdConfig):
        super().__init__()
        c = cfg.neck
        for i, w in enumerate(cfg.widths[1:]):
            setattr(self, f"lat{i}", nn.Conv2d(w, c, 1))
            setattr(self, f"smooth{i}", nn.Conv2d(c, c, 3, padding=1))
        for i in (1, 2):
            setattr(self, f"down{i}", nn.Conv2d(c, c, 3, stride=2, padding=1))

    def forward(self, feats):
        lat = [_conv(getattr(self, f"lat{i}"), f) for i, f in enumerate(feats)]
        # top-down; the crop covers odd feature sizes
        p = [None, None, lat[2]]
        for i in (1, 0):
            up = upsample2x(p[i + 1])[:, :, : lat[i].shape[2], : lat[i].shape[3]]
            p[i] = lat[i] + up
        p = [_conv(getattr(self, f"smooth{i}"), pi) for i, pi in enumerate(p)]
        # bottom-up augmentation
        n = [p[0], None, None]
        for i in (1, 2):
            n[i] = p[i] + _conv(getattr(self, f"down{i}"), n[i - 1])
        return n


class ScrfdHead(nn.Module):
    def __init__(self, cfg: ScrfdConfig):
        super().__init__()
        self.head_depth = cfg.head_depth
        for i in range(len(STRIDES)):
            cin = cfg.neck
            for d in range(cfg.head_depth):
                setattr(self, f"l{i}_conv{d}", nn.Conv2d(cin, cfg.head_width, 3, padding=1))
                setattr(self, f"l{i}_gn{d}", nn.GroupNorm(16, cfg.head_width, eps=1e-6))
                cin = cfg.head_width
            setattr(self, f"l{i}_cls", nn.Conv2d(cin, NUM_ANCHORS, 1))
            setattr(self, f"l{i}_box", nn.Conv2d(cin, NUM_ANCHORS * 4, 1))
            setattr(self, f"l{i}_kps", nn.Conv2d(cin, NUM_ANCHORS * cfg.num_keypoints * 2, 1))

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            for d in range(self.head_depth):
                x = _conv(getattr(self, f"l{i}_conv{d}"), x)
                x = torch.relu(getattr(self, f"l{i}_gn{d}")(x.float()))
            outs.append(
                {
                    # NHWC float32, as the flax head
                    k: _conv(getattr(self, f"l{i}_{k}"), x).float().permute(0, 2, 3, 1)
                    for k in ("cls", "box", "kps")
                }
            )
        return outs


class Scrfd(nn.Module):
    """images [B,H,W,3] in [0,1] -> per-level raw maps."""

    def __init__(self, cfg: ScrfdConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ScrfdBackbone(cfg)
        self.neck = Pafpn(cfg)
        self.head = ScrfdHead(cfg)

    def set_dtypes(self) -> "Scrfd":
        """Cast the conv weights to the config's compute dtype; the norms
        keep float32 parameters and statistics."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(self.cfg.compute_dtype)
        return self

    def forward(self, x: torch.Tensor):
        """x [B,H,W,3] (the flax layout)."""
        return self.forward_nchw(x.permute(0, 3, 1, 2))

    def forward_nchw(self, x: torch.Tensor):
        """x [B,3,H,W], as the sliced pipeline gathers it."""
        x = x.to(self.cfg.compute_dtype)
        # insightface normalisation: (pix*255 - 127.5) / 128
        x = (x * 255.0 - 127.5) / 128.0
        return self.head(self.neck(self.backbone(x)))


def _centers(fh: int, fw: int, stride: int, repeat: int, device) -> torch.Tensor:
    """Anchor centres (x, y) * stride with no half-cell offset, each repeated
    ``repeat`` times (anchor-fastest): [fh*fw*repeat, 2]."""
    ys = torch.arange(fh, dtype=torch.float32, device=device) * stride
    xs = torch.arange(fw, dtype=torch.float32, device=device) * stride
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    centers = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)
    return centers.repeat_interleave(repeat, dim=0)


def decode_scrfd(level_outputs: list[dict], num_keypoints: int = 5) -> dict:
    """Raw NHWC maps -> flat {boxes [B,A,4] xyxy px, scores [B,A,1], kpts
    [B,A,K,3]}.

    distance2bbox: anchor centres at (x, y) * stride; box = centre -/+ ltrb *
    stride; keypoints = centre + offset * stride (SCRFD convention)."""
    boxes, scores, kpts = [], [], []
    for lvl, stride in zip(level_outputs, STRIDES):
        b, h, w, _ = lvl["cls"].shape
        centers = _centers(h, w, stride, NUM_ANCHORS, lvl["cls"].device)

        cls = torch.sigmoid(lvl["cls"].reshape(b, -1, 1))
        dist = lvl["box"].reshape(b, -1, 4) * stride
        boxes.append(torch.cat([centers[None] - dist[..., :2], centers[None] + dist[..., 2:]], -1))
        scores.append(cls)

        kp = lvl["kps"].reshape(b, -1, num_keypoints, 2) * stride
        kxy = centers[None, :, None, :] + kp
        kv = cls[..., None, 0:1].expand(kxy.shape[:-1] + (1,))
        kpts.append(torch.cat([kxy, kv], -1))
    return {"boxes": torch.cat(boxes, 1), "scores": torch.cat(scores, 1), "kpts": torch.cat(kpts, 1)}


def decode_scrfd_flat(outs: tuple, input_hw: tuple[int, int]) -> dict:
    """Decode the flattened per-level outputs of an insightface SCRFD ONNX
    graph into {boxes [B,A,4] xyxy px, scores [B,A,1], kpts [B,A,K,3]}.

    Such graphs emit, in output order: score_8, score_16, score_32,
    bbox_8.., kps_8.., each level already sigmoided and flattened to
    [B, h*w*A, c] with bbox/kps in stride units (anchor-fastest). 6 outputs
    = no keypoint branch."""
    n_lv = len(STRIDES)
    if len(outs) not in (2 * n_lv, 3 * n_lv):
        raise ValueError(
            f"expected {2 * n_lv} or {3 * n_lv} outputs (scores/bbox[/kps] per "
            f"stride), got {len(outs)}"
        )
    has_kps = len(outs) == 3 * n_lv
    h, w = input_hw
    b = outs[0].shape[0]
    boxes, scores, kpts = [], [], []
    for i, stride in enumerate(STRIDES):
        cls = outs[i].reshape(b, -1, 1)
        dist = outs[i + n_lv].reshape(b, -1, 4) * stride
        fh, fw = -(-h // stride), -(-w // stride)
        na = cls.shape[1] // (fh * fw)
        centers = _centers(fh, fw, stride, na, cls.device)

        boxes.append(torch.cat([centers[None] - dist[..., :2], centers[None] + dist[..., 2:]], -1))
        scores.append(cls)
        if has_kps:
            kp_flat = outs[i + 2 * n_lv].reshape(b, cls.shape[1], -1)
            nk = kp_flat.shape[-1] // 2
            kxy = centers[None, :, None, :] + kp_flat.reshape(b, -1, nk, 2) * stride
        else:
            kxy = torch.zeros((b, cls.shape[1], 5, 2), dtype=torch.float32, device=cls.device)
        kv = cls[..., None, 0:1].expand(kxy.shape[:-1] + (1,))
        kpts.append(torch.cat([kxy, kv], -1))
    return {"boxes": torch.cat(boxes, 1), "scores": torch.cat(scores, 1), "kpts": torch.cat(kpts, 1)}


def create_scrfd(cfg: ScrfdConfig, seed: int = 0) -> Scrfd:
    """A ``Scrfd`` with random weights from a seeded ``torch.Generator``
    (made on the CPU: the caller moves it)."""
    model = Scrfd(cfg)
    random_init(model, seed)
    return model.set_dtypes().eval()
