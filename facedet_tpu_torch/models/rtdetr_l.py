"""The published RT-DETR-l (Lv et al., *DETRs Beat YOLOs on Real-time Object
Detection*, arXiv:2304.08069; Ultralytics ``rtdetr-l.yaml``) as a PyTorch
``nn.Module``: the inference forward.

Unlike the ``rtdetr-l`` preset of models/rtdetr.py, which keeps parity with
the JAX package's flax model, this is the network Ultralytics builds, module
for module, so that its ``state_dict`` keys are Ultralytics' own
(``model.0.stem1.conv.weight`` ... ``model.28.dec_bbox_head.5.layers.2.bias``)
and a published checkpoint's tensors load by name (``load_state``):

  * ``model.0`` ``HGStem``; ``model.1``-``model.9`` the HGNetv2-L stages
    (``HGBlock`` of six plain or light convolutions and a squeeze /
    excitation pair, ``DWConv`` stride-2 downsampling with no activation),
    giving P3, P4 and P5 at strides 8, 16 and 32;
  * ``model.10``-``model.27`` the hybrid encoder: a 1x1 projection of P5,
    ``AIFI`` (one post-norm transformer layer with the 2-D sin-cos
    embedding), the top-down and bottom-up CCFF paths of ``RepC3`` blocks
    and SiLU convs (``model.13/15/18/20/23/26`` are the upsamplings and
    concatenations, which hold no tensor);
  * ``model.28`` ``RTDETRDecoder``: per-level ``input_proj``, anchors of
    side 0.05 * 2^l with a validity mask, ``enc_output`` on the masked
    tokens, the top-k query selection by ``enc_score_head``,
    ``enc_bbox_head``, ``query_pos_head``, six decoder layers of
    self-attention, multi-scale deformable attention (one ``value_proj`` for
    all levels, over the ``input_proj`` tokens themselves: unmasked and not
    through ``enc_output``, as ``RTDETRDecoder.forward`` hands them to its
    decoder) and a ReLU FFN, each followed by its 3-layer box MLP; the last
    layer's score head.

Conventions as Ultralytics has them: every ``Conv`` is a conv, a BatchNorm
of eps 1e-3 (``initialize_weights`` sets it, also on ``input_proj``) and an
activation, ReLU in the backbone, SiLU in the neck (``layers.ConvBnAct``);
LayerNorm eps 1e-5 and exact GELU in ``AIFI``; the sin-cos embedding in
``build_2d_sincos_position_embedding``'s own order (its meshgrid is w-major,
the tokens h-major: on a square map the x and y halves of the embedding are
exchanged against the token grid, kept as published); ``torch.topk`` for the
query selection; evaluation at the last decoder layer, whose score head alone
runs; ``inverse_sigmoid`` with Ultralytics' eps of 1e-5
(``ultralytics/nn/modules/utils.py``; some accounts of the model give 1e-6).

Precision: convolutions and linears run in the config's dtype; the norms,
the softmax of the sampling weights, the bilinear sampling and its weighted
sum, the score ranking, the anchors and the box refinement in float32.
``forward_nchw(x, top_idx=...)`` takes the selected tokens from the caller,
to compare two runs whose encoder scores differ in their last digits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facedet_tpu_torch.models.layers import ConvBnAct, FlaxBatchNorm2d, Int8ConvBnAct, upsample2x
from facedet_tpu_torch.ops.kernels.bn_act import bn_act, bn_act_ref

__all__ = [
    "RtDetrLConfig",
    "RTDETR_L_VARIANTS",
    "STAGES",
    "RtDetrL",
    "sincos_2d",
    "generate_anchors",
    "inverse_sigmoid",
    "load_state",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# HGNetv2-L, per stage: (HGBlocks, kernel, light convolutions); the indices of
# Ultralytics' module list follow from it, so it is not a setting
STAGES = ((1, 3, False), (1, 3, False), (3, 5, True), (1, 5, True))
NUM_LEVELS = 3
DECODER = 28  # the index of RTDETRDecoder


@dataclasses.dataclass(frozen=True)
class RtDetrLConfig:
    num_classes: int = 1
    stem: tuple[int, int] = (32, 48)  # HGStem's cm and c2
    stage_mid: tuple[int, int, int, int] = (48, 96, 192, 384)  # each HGBlock's cm
    stage_out: tuple[int, int, int, int] = (128, 512, 1024, 2048)
    block_layers: int = 6  # convolutions of one HGBlock
    hidden_dim: int = 256
    ffn_dim: int = 1024  # AIFI's and each decoder layer's
    num_heads: int = 8
    repc3_depth: int = 3
    num_queries: int = 300
    num_points: int = 4
    num_decoder_layers: int = 6
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


RTDETR_L_VARIANTS = {
    "rtdetr-l-hgnetv2": RtDetrLConfig(),
    # the same layout at a few channels, for tests on the CPU
    "rtdetr-l-hgnetv2-tiny": RtDetrLConfig(stem=(8, 12), stage_mid=(8, 12, 16, 24), stage_out=(16, 32, 48, 64),
                                           block_layers=2, hidden_dim=32, ffn_dim=64, num_heads=4, repc3_depth=1,
                                           num_queries=30, num_decoder_layers=2),
}


def _in(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv or linear layer in its weight's dtype."""
    return m(x.to(m.weight.dtype))


class HGStem(nn.Module):
    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = ConvBnAct(c1, cm, 3, 2, act="relu")
        self.stem2a = ConvBnAct(cm, cm // 2, 2, 1, act="relu", padding=0)
        self.stem2b = ConvBnAct(cm // 2, cm, 2, 1, act="relu", padding=0)
        self.stem3 = ConvBnAct(2 * cm, cm, 3, 2, act="relu")
        self.stem4 = ConvBnAct(cm, c2, 1, 1, act="relu")

    def forward(self, x):
        x = F.pad(self.stem1(x), (0, 1, 0, 1))
        x2 = self.stem2b(F.pad(self.stem2a(x), (0, 1, 0, 1)))
        x1 = F.max_pool2d(x, 2, stride=1, ceil_mode=True)
        return self.stem4(self.stem3(torch.cat([x1, x2], dim=1)))


class LightConv(nn.Module):
    """A 1x1 conv with no activation, then a depthwise k x k conv."""

    def __init__(self, c1: int, c2: int, k: int):
        super().__init__()
        self.conv1 = ConvBnAct(c1, c2, 1, act=False)
        self.conv2 = ConvBnAct(c2, c2, k, groups=c2, act="relu")

    def forward(self, x):
        return self.conv2(self.conv1(x))


class HGBlock(nn.Module):
    def __init__(self, c1: int, cm: int, c2: int, k: int, n: int, light: bool, shortcut: bool):
        super().__init__()
        self.m = nn.ModuleList(
            LightConv(c1 if i == 0 else cm, cm, k) if light else ConvBnAct(c1 if i == 0 else cm, cm, k, act="relu")
            for i in range(n)
        )
        self.sc = ConvBnAct(c1 + n * cm, c2 // 2, 1, act="relu")
        self.ec = ConvBnAct(c2 // 2, c2, 1, act="relu")
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = [x]
        for m in self.m:
            y.append(m(y[-1]))
        out = self.ec(self.sc(torch.cat(y, dim=1)))
        return out + x if self.add else out


class RepConv(nn.Module):
    """SiLU(BN(conv3x3 x) + BN(conv1x1 x)), with no identity branch."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = ConvBnAct(c, c, 3, act=False)
        self.conv2 = ConvBnAct(c, c, 1, act=False)

    def forward(self, x):
        return F.silu(self.conv1(x) + self.conv2(x))


class RepC3(nn.Module):
    """``m(cv1 x) + cv2 x``; ``cv3`` is the identity (expansion 1)."""

    def __init__(self, c1: int, c2: int, n: int):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c2, 1)
        self.cv2 = ConvBnAct(c1, c2, 1)
        self.m = nn.Sequential(*(RepConv(c2) for _ in range(n)))

    def forward(self, x):
        return self.m(self.cv1(x)) + self.cv2(x)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s tensors (``in_proj_weight`` [3D, D],
    ``in_proj_bias``, ``out_proj``) and function, with no mask: the logits
    and their softmax in float32."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q_in, k_in, v_in):
        b, nq, d = q_in.shape
        nh, dh = self.num_heads, d // self.num_heads
        w, bias = self.in_proj_weight, self.in_proj_bias

        def heads(x, i):
            y = F.linear(x.to(w.dtype), w[i * d:(i + 1) * d], bias[i * d:(i + 1) * d])
            return y.reshape(b, -1, nh, dh).transpose(1, 2)  # [B, nh, N, dh]

        q, k, v = heads(q_in, 0), heads(k_in, 1), heads(v_in, 2)
        logits = torch.matmul(q * dh**-0.5, k.transpose(-1, -2)).float()
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, nq, d)
        return _in(self.out_proj, out)


def sincos_2d(w: int, h: int, dim: int, temperature: float = 10000.0, device=None) -> torch.Tensor:
    """[w*h, dim]: Ultralytics' ``AIFI.build_2d_sincos_position_embedding``,
    rows in its w-major meshgrid order (the products as elementwise
    multiplies: its [N, 1] @ [1, P] products, exactly)."""
    grid_w, grid_h = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=device),
                                    torch.arange(h, dtype=torch.float32, device=device), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (torch.arange(pos_dim, dtype=torch.float32, device=device) / pos_dim))
    out_w = grid_w.flatten()[:, None] * omega[None]
    out_h = grid_h.flatten()[:, None] * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], dim=1)


class Aifi(nn.Module):
    """One post-norm transformer encoder layer on the flattened P5 map:
    ``q = k = x + pos``, ``v = x``; exact GELU."""

    def __init__(self, c: int, cm: int, num_heads: int):
        super().__init__()
        self.ma = MultiheadAttention(c, num_heads)
        self.fc1 = nn.Linear(c, cm)
        self.fc2 = nn.Linear(cm, c)
        self.norm1 = nn.LayerNorm(c)
        self.norm2 = nn.LayerNorm(c)

    def forward(self, x):
        b, c, h, w = x.shape
        src = x.flatten(2).transpose(1, 2)  # [B, HW, C]
        q = src + sincos_2d(w, h, c, device=x.device).to(x.dtype)[None]
        src = self.norm1((src + self.ma(q, q, src)).float())
        y = _in(self.fc2, F.gelu(_in(self.fc1, src)))
        src = self.norm2((src + y).float())
        return src.transpose(1, 2).reshape(b, c, h, w)


class Mlp(nn.Module):
    """Linears with ReLU between them (Ultralytics' ``MLP``)."""

    def __init__(self, cin: int, hidden: int, cout: int, num_layers: int):
        super().__init__()
        dims = [cin] + [hidden] * (num_layers - 1) + [cout]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = _in(layer, x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class ProjBn(nn.Sequential):
    """``input_proj.l``: a 1x1 conv without bias (``0``) and a BatchNorm
    (``1``), normalised in float32, with a float32 output: on a CUDA tensor
    in eval mode one kernel, as ``ConvBnAct``'s epilogue."""

    def __init__(self, cin: int, c: int):
        super().__init__(nn.Conv2d(cin, c, 1, bias=False), FlaxBatchNorm2d(c, eps=1e-3, flax_momentum=0.97))

    def forward(self, x):
        x = _in(self[0], x)
        epilogue = bn_act_ref if self.training else bn_act
        return epilogue(x, self[1], torch.float32, False)


class MsDeformAttn(nn.Module):
    """Multi-scale deformable attention: one ``value_proj`` over the tokens of
    every level, split into heads; per level, one bilinear ``grid_sample`` of
    all heads' points; the samples summed under the softmax weights."""

    def __init__(self, d: int, num_levels: int, num_heads: int, num_points: int):
        super().__init__()
        self.nl, self.nh, self.npts = num_levels, num_heads, num_points
        self.sampling_offsets = nn.Linear(d, num_heads * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(d, num_heads * num_levels * num_points)
        self.value_proj = nn.Linear(d, d)
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, ref, value, shapes):
        """query [B,Q,D]; ref [B,Q,4] cxcywh in [0, 1], float32; value
        [B,S,D] the tokens of every level; shapes [(h, w)] per level."""
        b, nq, d = query.shape
        nh, nl, npts = self.nh, self.nl, self.npts
        dh = d // nh
        v = _in(self.value_proj, value).float()
        off = _in(self.sampling_offsets, query).float().reshape(b, nq, nh, nl, npts, 2)
        w = _in(self.attention_weights, query).float().reshape(b, nq, nh, nl * npts)
        w = torch.softmax(w, dim=-1)
        loc = ref[:, :, None, None, None, :2] + off / npts * ref[:, :, None, None, None, 2:] * 0.5
        grids = 2 * loc - 1  # [B, Q, nh, nl, P, 2]
        sampled, start = [], 0
        for level, (h, wd) in enumerate(shapes):
            v_l = v[:, start:start + h * wd].transpose(1, 2).reshape(b * nh, dh, h, wd)
            start += h * wd
            grid = grids[:, :, :, level].transpose(1, 2).flatten(0, 1)  # [B*nh, Q, P, 2]
            sampled.append(F.grid_sample(v_l, grid, mode="bilinear", padding_mode="zeros", align_corners=False))
        w = w.transpose(1, 2).reshape(b * nh, 1, nq, nl * npts)
        out = (torch.stack(sampled, dim=-2).flatten(-2) * w).sum(-1).reshape(b, d, nq).transpose(1, 2)
        return _in(self.output_proj, out)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: RtDetrLConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.self_attn = MultiheadAttention(d, cfg.num_heads)
        self.norm1 = nn.LayerNorm(d)
        self.cross_attn = MsDeformAttn(d, NUM_LEVELS, cfg.num_heads, cfg.num_points)
        self.norm2 = nn.LayerNorm(d)
        self.linear1 = nn.Linear(d, cfg.ffn_dim)
        self.linear2 = nn.Linear(cfg.ffn_dim, d)
        self.norm3 = nn.LayerNorm(d)

    def forward(self, embed, ref, tokens, shapes, pos):
        q = embed + pos
        embed = self.norm1((embed + self.self_attn(q, q, embed)).float())
        embed = self.norm2((embed + self.cross_attn(embed + pos, ref, tokens, shapes)).float())
        y = _in(self.linear2, F.relu(_in(self.linear1, embed)))
        return self.norm3((embed + y).float())


class _Decoder(nn.Module):
    def __init__(self, cfg: RtDetrLConfig):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_decoder_layers))


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Ultralytics' ``inverse_sigmoid``: ``x`` clamped to [0, 1], each side
    of the ratio to at least ``eps``."""
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def generate_anchors(shapes, device=None, grid_size: float = 0.05, eps: float = 1e-2):
    """(anchors [S, 4] in logits with +inf where invalid, valid [S, 1]):
    level l at h x w gives ``((x+0.5)/w, (y+0.5)/h, 0.05*2^l, 0.05*2^l)``
    h-major; valid where all four lie in (eps, 1 - eps)."""
    anchors = []
    for i, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
        xy = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], dim=-1).reshape(h * w, 2)
        wh = torch.ones_like(xy) * grid_size * (2.0**i)
        anchors.append(torch.cat([xy, wh], dim=-1))
    anchors = torch.cat(anchors, dim=0)
    valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdim=True)
    anchors = torch.log(anchors / (1 - anchors)).masked_fill(~valid, float("inf"))
    return anchors, valid


class RtDetrDecoder(nn.Module):
    """Ultralytics' ``RTDETRDecoder`` at evaluation. ``denoising_class_embed``
    is held for the checkpoint's sake; inference never reads it."""

    def __init__(self, cfg: RtDetrLConfig, channels):
        super().__init__()
        d = cfg.hidden_dim
        self.num_queries = cfg.num_queries
        self.input_proj = nn.ModuleList(ProjBn(c, d) for c in channels)
        self.decoder = _Decoder(cfg)
        self.denoising_class_embed = nn.Embedding(cfg.num_classes, d)
        self.query_pos_head = Mlp(4, 2 * d, d, 2)
        self.enc_output = nn.Sequential(nn.Linear(d, d), nn.LayerNorm(d))
        self.enc_score_head = nn.Linear(d, cfg.num_classes)
        self.enc_bbox_head = Mlp(d, d, 4, 3)
        self.dec_score_head = nn.ModuleList(nn.Linear(d, cfg.num_classes) for _ in range(cfg.num_decoder_layers))
        self.dec_bbox_head = nn.ModuleList(Mlp(d, d, 4, 3) for _ in range(cfg.num_decoder_layers))

    def forward(self, feats, top_idx=None):
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        shapes = [tuple(f.shape[2:]) for f in proj]
        # the decoder's value: the projected tokens as they are, unmasked
        tokens = torch.cat([f.flatten(2).transpose(1, 2) for f in proj], dim=1)  # [B, S, D] float32
        anchors, valid = generate_anchors(shapes, device=tokens.device)
        # enc_output feeds the scores, the selection and the first queries only
        memory = self.enc_output[1](_in(self.enc_output[0], valid * tokens).float())
        enc_scores = _in(self.enc_score_head, memory).float()
        if top_idx is None:
            top_idx = torch.topk(enc_scores.max(-1).values, self.num_queries, dim=1).indices
        embed = torch.gather(memory, 1, top_idx[..., None].expand(-1, -1, memory.shape[-1]))
        ref = self.enc_bbox_head(embed).float() + anchors[top_idx]
        ref = ref.sigmoid()
        layers = self.decoder.layers
        for i, layer in enumerate(layers):
            embed = layer(embed, ref, tokens, shapes, self.query_pos_head(ref))
            ref = torch.sigmoid(self.dec_bbox_head[i](embed).float() + inverse_sigmoid(ref))
        logits = _in(self.dec_score_head[len(layers) - 1], embed).float()
        return {"logits": [logits], "boxes": [ref], "top_idx": top_idx, "enc_scores": enc_scores}


class RtDetrL(nn.Module):
    """images [B,H,W,3] in [0, 1] (``forward``) or [B,3,H,W]
    (``forward_nchw``) -> {"logits": [last layer's, [B,Q,nc]], "boxes":
    [last layer's cxcywh in [0, 1]], "top_idx" [B,Q], "enc_scores" [B,S,nc]},
    the format ``rtdetr.decode_rtdetr`` reads. ``model`` is Ultralytics'
    module list, index for index."""

    # int8 (models/quantize.py): the stem stays float, as YOLO's does (its
    # 2x2 convs pad by 0); the decoder holds no ConvBnAct
    INT8_EXCLUDE = (("model", "0"),)

    def __init__(self, cfg: RtDetrLConfig):
        super().__init__()
        self.cfg = cfg
        c, d, n = cfg.stage_out, cfg.hidden_dim, cfg.block_layers
        mods: list[nn.Module] = [HGStem(3, *cfg.stem)]
        cin = cfg.stem[1]
        for stage, ((blocks, k, light), cm, cout) in enumerate(zip(STAGES, cfg.stage_mid, c)):
            if stage:
                mods.append(ConvBnAct(cin, cin, 3, 2, groups=cin, act=False))  # DWConv
            for j in range(blocks):
                mods.append(HGBlock(cin, cm, cout, k, n, light, shortcut=j > 0))
                cin = cout
        mods += [
            ConvBnAct(c[3], d, 1, act=False),  # 10
            Aifi(d, cfg.ffn_dim, cfg.num_heads),
            ConvBnAct(d, d, 1),  # 12: Y5
            nn.Identity(),  # upsample
            ConvBnAct(c[2], d, 1, act=False),  # 14
            nn.Identity(),  # concat
            RepC3(2 * d, d, cfg.repc3_depth),
            ConvBnAct(d, d, 1),  # 17: Y4
            nn.Identity(),
            ConvBnAct(c[1], d, 1, act=False),  # 19
            nn.Identity(),
            RepC3(2 * d, d, cfg.repc3_depth),  # 21: X3
            ConvBnAct(d, d, 3, 2),
            nn.Identity(),
            RepC3(2 * d, d, cfg.repc3_depth),  # 24: F4
            ConvBnAct(d, d, 3, 2),
            nn.Identity(),
            RepC3(2 * d, d, cfg.repc3_depth),  # 27: F5
            RtDetrDecoder(cfg, (d, d, d)),
        ]
        assert len(mods) == DECODER + 1
        self.model = nn.ModuleList(mods)

    def set_dtypes(self) -> "RtDetrL":
        """Cast conv and linear weights (and the attentions' projections) to
        the compute dtype and set every ``ConvBnAct``'s output dtype; the
        norms and the embedding table stay float32."""
        dt = self.cfg.compute_dtype
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, MultiheadAttention)):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(dt)
            elif isinstance(m, (ConvBnAct, Int8ConvBnAct)):
                m.bn_dtype = dt
        return self

    def features(self, x):
        """[X3, F4, F5], the encoder's outputs at strides 8, 16 and 32."""
        m = self.model
        x = m[2](m[1](m[0](x)))
        p3 = m[3](x)
        p4 = m[7](m[6](m[5](m[4](p3))))
        p5 = m[9](m[8](p4))
        y5 = m[12](m[11](m[10](p5)))
        y4 = m[17](m[16](torch.cat([upsample2x(y5), m[14](p4)], dim=1)))
        x3 = m[21](torch.cat([upsample2x(y4), m[19](p3)], dim=1))
        f4 = m[24](torch.cat([m[22](x3), y4], dim=1))
        f5 = m[27](torch.cat([m[25](f4), y5], dim=1))
        return [x3, f4, f5]

    def forward(self, x, top_idx=None):
        """x [B,H,W,3] (the layout ``quantize.calibrate`` feeds)."""
        return self.forward_nchw(x.permute(0, 3, 1, 2), top_idx)

    def forward_nchw(self, x, top_idx=None):
        return self.model[DECODER](self.features(x.to(self.cfg.compute_dtype)), top_idx)


def load_state(model: RtDetrL, sd: dict) -> None:
    """Load Ultralytics-named arrays ({name: array or tensor}, ``model.N.*``;
    a pickled model's own ``model.model.N.*`` too) into ``model`` strictly:
    every tensor of the module must be there (``KeyError`` otherwise) in its
    shape (``ValueError``); BatchNorm step counters are neither needed nor
    read, and tensors the module has no place for are ignored."""
    sd = {k[6:] if k.startswith("model.model.") else k: v for k, v in sd.items()}
    state = {}
    for key, want in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        if key not in sd:
            raise KeyError(f"the checkpoint has no {key}")
        v = sd[key]
        arr = v.detach().float().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {key}: module {tuple(want.shape)} vs checkpoint {tuple(arr.shape)}")
        state[key] = arr.to(want.dtype)
    model.load_state_dict(state, strict=False)
