"""YOLOv11 building blocks as NCHW ``nn.Module``s.

Counterpart of facedet_tpu/models/layers.py. Submodule names are the flax
names (``cv1``, ``m0``, ``attn.qkv``, ``bn`` ...), so a flax variable path maps
onto a state-dict key mechanically (models/from_jax.py). Flax infers input
channels; here each block is given them.

Parity notes: BatchNorm eps is 1e-3; ``padding=k//2`` is symmetric in both
frameworks; max-pool pads with -inf; in ``PSAAttention`` the qkv channels are
split per head as ``[heads, 2*key_dim + head_dim]``, as in the NHWC original.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "make_divisible",
    "ConvBnAct",
    "Bottleneck",
    "C3k",
    "C3k2",
    "SPPF",
    "PSAAttention",
    "PSABlock",
    "C2PSA",
    "upsample2x",
]


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm (inference statistics) + SiLU.

    The conv runs in its weight's dtype (flax's ``dtype``). The BatchNorm
    keeps float32 statistics and normalises in float32, as flax does (the
    conv output promotes against the float32 statistics), then casts to
    ``bn_dtype``. ``YoloV11.set_dtypes`` sets both."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(
            cin, cout, kernel, stride=stride, padding=kernel // 2, groups=groups, bias=False
        )
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)
        self.act = act
        self.bn_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x.to(self.conv.weight.dtype))
        x = self.bn(x.float()).to(self.bn_dtype)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """Two convs with an optional residual."""

    def __init__(self, cin: int, features: int, shortcut: bool = True, expansion: float = 0.5, kernels=(3, 3)):
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = ConvBnAct(cin, hidden, kernels[0])
        self.cv2 = ConvBnAct(hidden, features, kernels[1])
        self.residual = shortcut and cin == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.residual else y


class C3k(nn.Module):
    """CSP block with 3 convs and n inner bottlenecks."""

    def __init__(self, cin: int, features: int, n: int = 2, shortcut: bool = True, expansion: float = 0.5, kernel: int = 3):
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = ConvBnAct(cin, hidden, 1)
        self.cv2 = ConvBnAct(cin, hidden, 1)
        self.n = n
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(hidden, hidden, shortcut, 1.0, (kernel, kernel)))
        self.cv3 = ConvBnAct(2 * hidden, features, 1)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class C3k2(nn.Module):
    """YOLOv11's C2f-with-C3k-option block."""

    def __init__(self, cin: int, features: int, n: int = 1, c3k: bool = False, expansion: float = 0.5, shortcut: bool = True):
        super().__init__()
        self.hidden = hidden = int(features * expansion)
        self.cv1 = ConvBnAct(cin, 2 * hidden, 1)
        self.n = n
        for i in range(n):
            block = (
                C3k(hidden, hidden, 2, shortcut)
                if c3k
                else Bottleneck(hidden, hidden, shortcut, 0.5)
            )
            setattr(self, f"m{i}", block)
        self.cv2 = ConvBnAct((2 + n) * hidden, features, 1)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, : self.hidden], y[:, self.hidden :]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained stride-1 max-pools."""

    def __init__(self, cin: int, features: int, pool: int = 5):
        super().__init__()
        hidden = cin // 2
        self.pool = pool
        self.cv1 = ConvBnAct(cin, hidden, 1)
        self.cv2 = ConvBnAct(4 * hidden, features, 1)

    def forward(self, x):
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], self.pool, stride=1, padding=self.pool // 2))
        return self.cv2(torch.cat(outs, dim=1))


class PSAAttention(nn.Module):
    """Position-sensitive attention over the HxW grid."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        nh_kd = self.key_dim * num_heads
        self.qkv = ConvBnAct(dim, dim + 2 * nh_kd, 1, act=False)
        self.pe = ConvBnAct(dim, dim, 3, groups=dim, act=False)
        self.proj = ConvBnAct(dim, dim, 1, act=False)

    def forward(self, x):
        b, _, h, w = x.shape
        n = h * w
        kd = self.key_dim
        qkv = self.qkv(x).reshape(b, self.num_heads, 2 * kd + self.head_dim, n)
        q, k, v = qkv[:, :, :kd], qkv[:, :, kd : 2 * kd], qkv[:, :, 2 * kd :]
        # logits and softmax in float32 (JAX: preferred_element_type=float32)
        attn = torch.matmul(q.float().transpose(-1, -2), k.float())  # [b, heads, n, m]
        attn = torch.softmax(attn * (kd**-0.5), dim=-1).to(x.dtype)
        out = torch.matmul(v.to(x.dtype), attn.transpose(-1, -2))  # [b, heads, hd, n]
        out = out.reshape(b, self.dim, h, w)
        out = out + self.pe(v.reshape(b, self.dim, h, w))
        return self.proj(out)


class PSABlock(nn.Module):
    def __init__(self, features: int, num_heads: int):
        super().__init__()
        self.attn = PSAAttention(features, num_heads)
        self.ffn0 = ConvBnAct(features, features * 2, 1)
        self.ffn1 = ConvBnAct(features * 2, features, 1, act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn1(self.ffn0(x))


class C2PSA(nn.Module):
    """Cross-stage partial block with PSA attention."""

    def __init__(self, cin: int, features: int, n: int = 1, expansion: float = 0.5):
        super().__init__()
        self.hidden = hidden = int(features * expansion)
        self.cv1 = ConvBnAct(cin, 2 * hidden, 1)
        self.n = n
        for i in range(n):
            setattr(self, f"m{i}", PSABlock(hidden, max(1, hidden // 64)))
        self.cv2 = ConvBnAct(2 * hidden, features, 1)

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[:, : self.hidden], y[:, self.hidden :]
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
        return self.cv2(torch.cat([a, b], dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (NCHW)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
