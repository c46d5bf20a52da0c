"""YOLOv11(-pose) as a PyTorch ``nn.Module``.

Counterpart of facedet_tpu/models/yolov11.py: CSP backbone with C3k2 blocks,
SPPF, C2PSA attention, PAN-FPN neck, decoupled DFL detect head and a
5-keypoint pose branch. ``YoloV11.forward`` takes NHWC images in [0, 1] and
returns per-level ``{"box", "cls", "kpt"}`` maps in NHWC float32, as the flax
module does; the convs run NCHW (``forward_nchw``). The TPU-only space-to-depth rewrite of the
early backbone (models/yolo_s2d.py) is the same math and is not ported.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from facedet_tpu_torch.models.init import random_init
from facedet_tpu_torch.models.layers import C2PSA, C3k2, ConvBnAct, Int8ConvBnAct, SPPF, make_divisible, upsample2x

__all__ = ["SCALES", "STRIDES", "REG_MAX", "YoloConfig", "Backbone", "PanNeck", "DetectHead", "YoloV11", "create_yolo"]

# depth multiple, width multiple, max channels — published YOLOv11 scales
SCALES: dict[str, tuple[float, float, int]] = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}

STRIDES = (8, 16, 32)
REG_MAX = 16

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    scale: str = "s"
    num_classes: int = 1  # 'face'
    num_keypoints: int = 5
    kpt_dims: int = 3
    with_pose: bool = True
    dtype: str = "float32"
    bn_dtype: str = "float32"  # BatchNorm/activation compute dtype

    def ch(self, c: int) -> int:
        _, width, max_ch = SCALES[self.scale]
        return make_divisible(min(c, max_ch) * width, 8)

    def depth(self, n: int) -> int:
        d, _, _ = SCALES[self.scale]
        return max(1, round(n * d))

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def bn_compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.bn_dtype]


class Backbone(nn.Module):
    def __init__(self, cfg: YoloConfig):
        super().__init__()
        c, d = cfg.ch, cfg.depth(2)
        self.stem = ConvBnAct(3, c(64), 3, 2)  # P1/2
        self.down1 = ConvBnAct(c(64), c(128), 3, 2)  # P2/4
        self.c3k2_0 = C3k2(c(128), c(256), d, c3k=False, expansion=0.25)
        self.down2 = ConvBnAct(c(256), c(256), 3, 2)  # P3/8
        self.c3k2_1 = C3k2(c(256), c(512), d, c3k=False, expansion=0.25)
        self.down3 = ConvBnAct(c(512), c(512), 3, 2)  # P4/16
        self.c3k2_2 = C3k2(c(512), c(512), d, c3k=True)
        self.down4 = ConvBnAct(c(512), c(1024), 3, 2)  # P5/32
        self.c3k2_3 = C3k2(c(1024), c(1024), d, c3k=True)
        self.sppf = SPPF(c(1024), c(1024), 5)
        self.c2psa = C2PSA(c(1024), c(1024), d)

    STAGES = ("stem", "down1", "c3k2_0", "down2", "c3k2_1", "down3", "c3k2_2", "down4", "c3k2_3", "sppf", "c2psa")

    def forward(self, x):
        return tuple(self.features(x, ("c3k2_1", "c3k2_2", "c2psa")))  # p3, p4, p5

    def features(self, x, names) -> list:
        """The outputs of the named stages, in the order of ``names``
        (flax's ``capture_intermediates`` by module name); the stages after
        the last one named do not run."""
        out = {}
        for stage in self.STAGES[: max(self.STAGES.index(n) for n in names) + 1]:
            x = getattr(self, stage)(x)
            out[stage] = x
        return [out[n] for n in names]


class PanNeck(nn.Module):
    def __init__(self, cfg: YoloConfig):
        super().__init__()
        c, d = cfg.ch, cfg.depth(2)
        big = cfg.scale in ("l", "x", "m")
        self.up0 = C3k2(c(1024) + c(512), c(512), d, c3k=big)
        self.up1 = C3k2(c(512) + c(512), c(256), d, c3k=big)
        self.down0 = ConvBnAct(c(256), c(256), 3, 2)
        self.pan0 = C3k2(c(256) + c(512), c(512), d, c3k=big)
        self.down1 = ConvBnAct(c(512), c(512), 3, 2)
        self.pan1 = C3k2(c(512) + c(1024), c(1024), d, c3k=True)

    STEPS = ("up0", "up1", "pan_down0", "pan0", "pan_down1", "pan1")

    def forward(self, feats):
        out = dict(self.steps(feats))
        return out["up1"], out["pan0"], out["pan1"]  # n3, m4, m5

    def steps(self, feats):
        """Yields (step, output) in ``STEPS`` order, the names of the JAX
        profile tool (``pan_down0`` is the module ``down0``); a caller that
        stops iterating runs no later step."""
        p3, p4, p5 = feats
        n4 = self.up0(torch.cat([upsample2x(p5), p4], dim=1))
        yield "up0", n4
        n3 = self.up1(torch.cat([upsample2x(n4), p3], dim=1))
        yield "up1", n3
        d = self.down0(n3)
        yield "pan_down0", d
        m4 = self.pan0(torch.cat([d, n4], dim=1))
        yield "pan0", m4
        d = self.down1(m4)
        yield "pan_down1", d
        yield "pan1", self.pan1(torch.cat([d, p5], dim=1))


class DetectHead(nn.Module):
    """Decoupled anchor-free head: DFL box branch, depthwise-separable cls
    branch, optional pose branch (K keypoints x (x, y, vis))."""

    def __init__(self, cfg: YoloConfig):
        super().__init__()
        chans = [cfg.ch(256), cfg.ch(512), cfg.ch(1024)]
        c2 = max(16, chans[0] // 4, REG_MAX * 4)
        c3 = max(chans[0], min(cfg.num_classes, 100))
        nk = cfg.num_keypoints * cfg.kpt_dims
        c4 = max(chans[0] // 4, nk)
        self.with_pose = cfg.with_pose
        for i, f in enumerate(chans):
            setattr(self, f"box{i}_0", ConvBnAct(f, c2, 3))
            setattr(self, f"box{i}_1", ConvBnAct(c2, c2, 3))
            setattr(self, f"box{i}_2", nn.Conv2d(c2, 4 * REG_MAX, 1))
            setattr(self, f"cls{i}_dw0", ConvBnAct(f, f, 3, groups=f))
            setattr(self, f"cls{i}_pw0", ConvBnAct(f, c3, 1))
            setattr(self, f"cls{i}_dw1", ConvBnAct(c3, c3, 3, groups=c3))
            setattr(self, f"cls{i}_pw1", ConvBnAct(c3, c3, 1))
            setattr(self, f"cls{i}_out", nn.Conv2d(c3, cfg.num_classes, 1))
            if cfg.with_pose:
                setattr(self, f"kpt{i}_0", ConvBnAct(f, c4, 3))
                setattr(self, f"kpt{i}_1", ConvBnAct(c4, c4, 3))
                setattr(self, f"kpt{i}_2", nn.Conv2d(c4, nk, 1))

    def _branch(self, names, x):
        for name in names:
            m = getattr(self, name)
            x = m(x.to(m.weight.dtype)) if isinstance(m, nn.Conv2d) else m(x)
        return x.float().permute(0, 2, 3, 1)  # NHWC float32, as the flax head

    def branches(self, i: int) -> dict[str, list[str]]:
        """Level ``i``'s branches: {"box", "cls"[, "kpt"]} -> their layers."""
        out = {
            "box": [f"box{i}_0", f"box{i}_1", f"box{i}_2"],
            "cls": [f"cls{i}_dw0", f"cls{i}_pw0", f"cls{i}_dw1", f"cls{i}_pw1", f"cls{i}_out"],
        }
        if self.with_pose:
            out["kpt"] = [f"kpt{i}_0", f"kpt{i}_1", f"kpt{i}_2"]
        return out

    def forward(self, feats):
        return [{b: self._branch(names, f) for b, names in self.branches(i).items()} for i, f in enumerate(feats)]


class YoloV11(nn.Module):
    """Full detector: images [B,H,W,3] in [0,1] -> per-level NHWC raw maps."""

    def __init__(self, cfg: YoloConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.neck = PanNeck(cfg)
        self.head = DetectHead(cfg)

    def set_dtypes(self) -> "YoloV11":
        """Cast conv weights to the config's compute dtype and set every
        BatchNorm's output dtype (flax's ``dtype`` / ``bn_dtype``)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(self.cfg.compute_dtype)
            elif isinstance(m, (ConvBnAct, Int8ConvBnAct)):
                m.bn_dtype = self.cfg.bn_compute_dtype
        return self

    def forward(self, x: torch.Tensor):
        """x [B,H,W,3] (the flax layout)."""
        return self.forward_nchw(x.permute(0, 3, 1, 2))

    def forward_nchw(self, x: torch.Tensor):
        """x [B,3,H,W]: the layout the convs take, as the sliced pipeline
        gathers it."""
        x = x.to(self.cfg.compute_dtype)
        return self.head(self.neck(self.backbone(x)))


def create_yolo(cfg: YoloConfig, seed: int, image_size: int = 640, device=None) -> YoloV11:
    """A ``YoloV11(cfg)`` with random weights from ``seed`` (a seeded
    ``torch.Generator`` through ``models/init.random_init``, where the JAX
    package takes a PRNG key), its convs in the config's dtype, in eval
    mode, on ``device`` (default: the card; it raises without one, and
    ``"cpu"`` runs without it). The JAX function returns (module,
    variables); a torch module holds its variables. ``image_size`` is the
    JAX signature's, which sizes flax's dummy init input: no shape of the
    torch module depends on it."""
    from facedet_tpu_torch.engine.detector import resolve_device

    del image_size
    dev = resolve_device(device)
    model = YoloV11(cfg)
    random_init(model, seed)
    return model.set_dtypes().eval().to(dev)
