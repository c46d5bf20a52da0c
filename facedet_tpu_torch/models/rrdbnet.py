"""RRDBNet (Real-ESRGAN generator) as ``nn.Module``s.

Counterpart of facedet_tpu/models/rrdbnet.py: the 23-block x4 net, the
6-block anime variant and the 23-block x2 net with pixel-unshuffled input.
The submodules carry the flax names (``conv_first``, ``body0.rdb1.conv1``,
...), so a checkpoint of the JAX package loads through models/from_jax.py
without a name table. The convs are cuDNN convs, as the JAX package leaves
them to XLA; the compute is NCHW, and ``forward`` takes and returns the flax
layout (NHWC). Tiled execution lives in engine/enhancer.py.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.2


@dataclasses.dataclass(frozen=True)
class RRDBConfig:
    num_in_ch: int = 3
    num_out_ch: int = 3
    scale: int = 4  # network upscale (2 and 1 pixel-unshuffle their input)
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


# Published Real-ESRGAN model catalog
MODEL_CATALOG: dict[str, RRDBConfig] = {
    "RealESRGAN_x4plus": RRDBConfig(scale=4, num_block=23),
    "RealESRGAN_x4plus_anime_6B": RRDBConfig(scale=4, num_block=6),
    "RealESRGAN_x2plus": RRDBConfig(scale=2, num_block=23),
}


def pixel_unshuffle_nchw(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B,C,H,W] -> [B,C*f*f,H/f,W/f] with the channel order of the flax
    net: output channel ``(fy*f + fx)*C + c``. ``F.pixel_unshuffle`` orders
    them ``c*f*f + fy*f + fx``; with that order ``conv_first`` of a carried
    checkpoint would read the wrong planes."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // factor, factor, w // factor, factor)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, c * factor * factor, h // factor, w // factor)


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B,H,W,C] -> [B,H/f,W/f,C*f*f] (space-to-depth), the flax layout."""
    return pixel_unshuffle_nchw(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


def _conv(c_in: int, c_out: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, padding=1)


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"conv{i}", _conv(num_feat + (i - 1) * num_grow_ch, num_grow_ch))
        self.conv5 = _conv(num_feat + 4 * num_grow_ch, num_feat)

    def forward(self, x):
        x1 = _act(self.conv1(x))
        x2 = _act(self.conv2(torch.cat([x, x1], 1)))
        x3 = _act(self.conv3(torch.cat([x, x1, x2], 1)))
        x4 = _act(self.conv4(torch.cat([x, x1, x2, x3], 1)))
        x5 = self.conv5(torch.cat([x, x1, x2, x3, x4], 1))
        return x + 0.2 * x5


class RRDB(nn.Module):
    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """images [B,H,W,3] in [0,1] -> [B,H*scale,W*scale,3] float32."""

    def __init__(self, cfg: RRDBConfig):
        super().__init__()
        self.cfg = cfg
        unshuffle = {2: 2, 1: 4}.get(cfg.scale, 1)
        self.unshuffle = unshuffle
        self.conv_first = _conv(cfg.num_in_ch * unshuffle * unshuffle, cfg.num_feat)
        for i in range(cfg.num_block):
            setattr(self, f"body{i}", RRDB(cfg.num_feat, cfg.num_grow_ch))
        self.conv_body = _conv(cfg.num_feat, cfg.num_feat)
        self.conv_up1 = _conv(cfg.num_feat, cfg.num_feat)
        self.conv_up2 = _conv(cfg.num_feat, cfg.num_feat)
        self.conv_hr = _conv(cfg.num_feat, cfg.num_feat)
        self.conv_last = _conv(cfg.num_feat, cfg.num_out_ch)

    def set_dtypes(self) -> "RRDBNet":
        """Cast the parameters to the config's compute dtype. flax keeps
        float32 parameters and casts them at each conv; the rounded weights
        a conv sees are the same."""
        return self.to(self.cfg.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,H,W,3] (the flax layout)."""
        return self.forward_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,3,H,W] -> [B,3,H*scale,W*scale] float32."""
        cfg = self.cfg
        x = x.to(self.conv_first.weight.dtype)
        if self.unshuffle > 1:
            x = pixel_unshuffle_nchw(x, self.unshuffle)
        feat = self.conv_first(x)
        body = feat
        for i in range(cfg.num_block):
            body = getattr(self, f"body{i}")(body)
        feat = feat + self.conv_body(body)
        # nearest-neighbour x2: output pixel i reads input pixel i // 2, as
        # jax.image.resize(..., "nearest") at an integer factor
        feat = _act(self.conv_up1(F.interpolate(feat, scale_factor=2, mode="nearest")))
        feat = _act(self.conv_up2(F.interpolate(feat, scale_factor=2, mode="nearest")))
        feat = _act(self.conv_hr(feat))
        return self.conv_last(feat).float()


def init_rrdbnet_(model: RRDBNet, generator: torch.Generator) -> None:
    """flax's default init from a seeded generator: conv kernels
    N(0, 1/fan_in) (lecun normal without the truncation), biases 0."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * fan_in**-0.5)
                m.bias.zero_()


def create_rrdbnet(cfg: RRDBConfig, generator: torch.Generator | None = None, size: int = 64) -> RRDBNet:
    """A randomly initialised net (``size`` is accepted for signature parity:
    a torch module needs no example input)."""
    model = RRDBNet(cfg)
    init_rrdbnet_(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model
