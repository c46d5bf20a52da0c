"""TOPIQ / CFANet no-reference IQA network (counterpart of
facedet_tpu/models/topiq.py).

The reference's IQA table carries a TOPIQ-Face column produced by pyiqa's
``topiq_nr-face`` metric (reference: pipeline_v4_yolo/1_Inference.py:121-150,
``hasil eval niqe.txt:4,15-16``). That model is CFANet (Chen et al., 2023): a
ResNet50 feature pyramid whose coarsest scale guides attention top-down
through cross-scale attention blocks, ending in a score head.

  1. ResNet50 backbone, stage outputs C2..C5 (256/512/1024/2048 channels at
     strides 4/8/16/32).
  2. 1x1 reduction per scale to ``embed_dim`` and a VALID average pool onto
     the coarsest grid, with the window ``f_h // g_h`` on both axes (so a
     crop that is not square gives other token counts per scale: 16, 16, 49
     and 16 at 100x100).
  3. Self-attention over the coarsest tokens, then cross-scale attention
     top-down: queries from the next finer scale, keys and values from the
     attended coarser stream.
  4. Mean-token MLP score head, sigmoid in float32.

Attribute names follow the state-dict layout that the JAX package's
``convert_topiq_torch`` reads (``backbone.layer{s}_{b}.conv1``,
``reduce{i}``, ``scale_embed{i}``, ``self{j}.attn.in_proj_weight``, ...), so a
torch checkpoint in that layout loads with ``load_state_dict(strict=True)``;
flax variables go in through ``models/from_jax.load_topiq_variables``.

Parity with flax: tokens are taken from NHWC order (a map is permuted before
it is flattened); BatchNorm eps 1e-5 (flax's default) and float32, with
flax's train-mode statistics (momentum 0.99, ``FlaxBatchNorm2d``), LayerNorm
eps 1e-5 and float32, exact GELU; convs and linears run in the config's
dtype, the ImageNet normalisation in that dtype after the cast, the sigmoid
in float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facedet_tpu_torch.models.layers import FlaxBatchNorm2d

__all__ = [
    "TopiqConfig",
    "BottleneckRes",
    "ResNet50",
    "AttnBlock",
    "CFANet",
    "create_topiq",
    "init_topiq_",
    "topiq_score",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class TopiqConfig:
    embed_dim: int = 256
    num_heads: int = 4
    num_attn_blocks: int = 1
    mlp_ratio: float = 4.0
    # resnet50 stage widths/depths
    stage_channels: tuple = (256, 512, 1024, 2048)
    stage_depths: tuple = (3, 4, 6, 3)
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def _in(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv or linear layer in its weight's dtype (flax's ``dtype``)."""
    return m(x.to(m.weight.dtype))


def _bn(m: FlaxBatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in float32 (flax: ``dtype=jnp.float32``)."""
    return m(x.float())


class BottleneckRes(nn.Module):
    """ResNet-v1 bottleneck: 1x1 -> 3x3 -> 1x1 with BN and a projection when
    the width or the stride changes."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        width = features // 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = FlaxBatchNorm2d(width, eps=1e-5)
        self.conv2 = nn.Conv2d(width, width, 3, stride, padding=1, bias=False)
        self.bn2 = FlaxBatchNorm2d(width, eps=1e-5)
        self.conv3 = nn.Conv2d(width, features, 1, bias=False)
        self.bn3 = FlaxBatchNorm2d(features, eps=1e-5)
        self.has_down = cin != features or stride != 1
        if self.has_down:
            # flax's "SAME" pads a 1x1 kernel by nothing, at any stride
            self.down_conv = nn.Conv2d(cin, features, 1, stride, bias=False)
            self.down_bn = FlaxBatchNorm2d(features, eps=1e-5)

    def forward(self, x):
        y = torch.relu(_bn(self.bn1, _in(self.conv1, x)))
        y = torch.relu(_bn(self.bn2, _in(self.conv2, y)))
        y = _bn(self.bn3, _in(self.conv3, y))
        if self.has_down:
            x = _bn(self.down_bn, _in(self.down_conv, x))
        return torch.relu(x + y)


class ResNet50(nn.Module):
    """Torchvision-layout ResNet50 trunk emitting the C2..C5 stage maps."""

    def __init__(self, cfg: TopiqConfig):
        super().__init__()
        self.stage_depths = tuple(cfg.stage_depths)
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.stem_bn = FlaxBatchNorm2d(64, eps=1e-5)
        cin = 64
        for s, (ch, depth) in enumerate(zip(cfg.stage_channels, cfg.stage_depths)):
            for b in range(depth):
                stride = 2 if (b == 0 and s > 0) else 1
                setattr(self, f"layer{s + 1}_{b}", BottleneckRes(cin, ch, stride))
                cin = ch

    def forward(self, x):
        x = torch.relu(_bn(self.stem_bn, _in(self.stem_conv, x)))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf, as flax's max_pool
        outs = []
        for s, depth in enumerate(self.stage_depths):
            for b in range(depth):
                x = getattr(self, f"layer{s + 1}_{b}")(x)
            outs.append(x)
        return outs


class MultiheadAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (values from the keys' input)
    with the parameters of ``nn.MultiheadAttention``: one packed
    ``in_proj_weight [3D, D]`` (query, key, value) and ``out_proj``. The
    query is scaled before the product and the softmax runs in float32."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q_in, kv_in):
        b, nq, d = q_in.shape
        nh, dh = self.num_heads, d // self.num_heads
        dt = self.in_proj_weight.dtype
        w, bias = self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)

        def heads(i, x):
            return F.linear(x.to(dt), w[i], bias[i]).reshape(b, -1, nh, dh).transpose(1, 2)  # [B, nh, N, dh]

        q, k, v = heads(0, q_in), heads(1, kv_in), heads(2, kv_in)
        logits = torch.matmul(q / dh**0.5, k.transpose(-1, -2))
        attn = torch.softmax(logits.float(), dim=-1).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, nq, d)
        return _in(self.out_proj, out)


class AttnBlock(nn.Module):
    """Pre-norm transformer block; cross-attention when ``kv`` is given."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm_q = nn.LayerNorm(dim, eps=1e-5)
        self.norm_kv = nn.LayerNorm(dim, eps=1e-5)
        self.norm_mlp = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiheadAttention(dim, num_heads)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, q, kv=None):
        kv_in = q if kv is None else kv
        x = q + self.attn(self.norm_q(q.float()), self.norm_kv(kv_in.float())).float()
        y = F.gelu(_in(self.fc1, self.norm_mlp(x)), approximate="none")
        return x + _in(self.fc2, y).float()


class CFANet(nn.Module):
    """images [B,H,W,3] in [0,1] -> quality score [B] (sigmoid range)."""

    def __init__(self, cfg: TopiqConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet50(cfg)
        n_scales = len(cfg.stage_channels)
        for i, ch in enumerate(cfg.stage_channels):
            setattr(self, f"reduce{i}", nn.Conv2d(ch, cfg.embed_dim, 1))
            self.register_parameter(f"scale_embed{i}", nn.Parameter(torch.zeros(cfg.embed_dim)))
        for j in range(cfg.num_attn_blocks):
            setattr(self, f"self{j}", AttnBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio))
        for i in range(n_scales - 1):
            setattr(self, f"cross{i}", AttnBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio))
        self.head_fc1 = nn.Linear(cfg.embed_dim, cfg.embed_dim)
        self.head_fc2 = nn.Linear(cfg.embed_dim, 1)

    def set_dtypes(self) -> "CFANet":
        """Cast conv, linear and attention weights to the config's compute
        dtype; the norms and the scale embeddings stay float32."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, MultiheadAttention)):
                m.to(self.cfg.compute_dtype)
        return self

    def forward(self, x):
        """x [B,H,W,3] (the flax layout)."""
        return self.forward_nchw(x.permute(0, 3, 1, 2))

    def forward_nchw(self, x):
        """x [B,3,H,W] in [0,1] -> [B] float32."""
        cfg, dt = self.cfg, self.cfg.compute_dtype
        x = x.to(dt)
        mean = torch.tensor(_IMAGENET_MEAN, dtype=dt, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(_IMAGENET_STD, dtype=dt, device=x.device).view(1, 3, 1, 1)
        feats = self.backbone((x - mean) / std)

        gh = feats[-1].shape[2]
        tokens = []
        for i, f in enumerate(feats):
            r = _in(getattr(self, f"reduce{i}"), f)
            fh = f.shape[2] // gh  # one window for both axes, as the reference
            if fh > 1:
                r = F.avg_pool2d(r, fh, fh)
            # NHWC order before the flatten: flax's token order
            t = r.permute(0, 2, 3, 1).reshape(r.shape[0], -1, cfg.embed_dim)
            tokens.append(t + getattr(self, f"scale_embed{i}"))

        stream = tokens[-1]
        for j in range(cfg.num_attn_blocks):
            stream = getattr(self, f"self{j}")(stream)
        for i in range(len(tokens) - 2, -1, -1):
            stream = getattr(self, f"cross{i}")(tokens[i], kv=stream)

        pooled = stream.mean(dim=1)
        h = F.gelu(_in(self.head_fc1, pooled), approximate="none")
        return torch.sigmoid(_in(self.head_fc2, h)[..., 0].float())


def init_topiq_(model: CFANet, generator: torch.Generator) -> None:
    """Random weights from a seeded CPU generator, flax's init without the
    truncation: conv, linear and attention kernels N(0, 1/fan_in), biases 0,
    scale embeddings N(0, 0.02^2); the norms keep scale 1, bias 0, mean 0,
    var 1."""
    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                normal(m.weight, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MultiheadAttention):
                normal(m.in_proj_weight, m.in_proj_weight.shape[1] ** -0.5)
                m.in_proj_bias.zero_()
        for i in range(len(model.cfg.stage_channels)):
            normal(getattr(model, f"scale_embed{i}"), 0.02)


def create_topiq(cfg: TopiqConfig | None = None, generator: torch.Generator | None = None,
                 device="cuda") -> CFANet:
    """A randomly initialised CFANet in eval mode on ``device``: the weights
    are drawn on the CPU, so one seed gives one model on every device."""
    from facedet_tpu_torch.engine.detector import resolve_device

    device = resolve_device(device)
    model = CFANet(cfg or TopiqConfig())
    init_topiq_(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.set_dtypes().to(device).eval()


def topiq_score(model: CFANet, images) -> np.ndarray | float:
    """uint8/float RGB [B,H,W,3] (or [H,W,3]) -> scores [B] (or a float), as
    numpy. A tensor input goes to the model's device as it is; values above
    1.5 are taken as 0-255 and divided by 255, as in the reference. A
    float32 model runs with TF32 off, as the detectors' fidelity mode."""
    from facedet_tpu_torch.engine.detector import _exact_float32

    device = next(model.parameters()).device
    if isinstance(images, torch.Tensor):
        x = images.to(device=device, dtype=torch.float32)
    else:
        x = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    one = x.dim() == 3
    if float(x.max()) > 1.5:
        x = x / 255.0
    if one:
        x = x[None]
    with torch.inference_mode(), _exact_float32(model.cfg.dtype == "float32"):
        out = model(x).cpu().numpy()
    return float(out[0]) if one else out
