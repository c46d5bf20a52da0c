"""RT-DETR detector as a PyTorch ``nn.Module``: the inference forward.

Counterpart of facedet_tpu/models/rtdetr.py:
  * ResNet-style backbone with stride 8/16/32 outputs.
  * Hybrid encoder: AIFI, one transformer encoder layer on the stride-32 map
    with a 2D sincos positional embedding, plus CCFF cross-scale fusion.
  * Decoder with multi-scale deformable cross-attention, top-K query
    selection from the encoder tokens, and iterative box refinement in
    inverse-sigmoid space.
  * Heads: per-layer class logits and cxcywh boxes (sigmoid, normalised).

``RtDetr.forward`` takes NHWC images in [0, 1]; the convs run NCHW
(``forward_nchw``). Submodules carry the flax names (the auto-named
``Conv_0``/``BatchNorm_0`` of ``ConvBnRelu`` included), so flax checkpoints
load by name through models/from_jax.py. Training passes contrastive-
denoising (CDN) queries (``dn_labels``, ``dn_ref``, ``dn_groups``): they go
through the decoder before the matching queries behind
``dn_attention_mask`` and come back as ``dn_logits`` / ``dn_boxes``.

Parity notes: BatchNorm eps 1e-5 and LayerNorm eps 1e-6 (flax's defaults),
flax's train-mode BatchNorm statistics (momentum 0.99, ``FlaxBatchNorm2d``);
GELU is the tanh approximation; convs and linears run in the config's dtype,
the norms, the softmax of the sampling weights, the accumulation of samples
and the box refinement in float32; the refined reference is detached after
every decoder layer but the last, before the layer's boxes are read, so
only the last layer's boxes carry a gradient (as the flax model does); queries and keys carry the positional
term and values do not; ``jax.image.resize(..., "nearest")`` is torch's
``nearest-exact``; sampling coordinates ``loc*W - 0.5`` with zeros outside
are ``grid_sample(align_corners=False, padding_mode="zeros")``, here on each
head's own ``dh`` channels (the JAX code samples all channels for every head
and takes the diagonal: the same function); ``lax.top_k`` breaks ties toward
the lower index, so the selection is a stable descending sort cut to k.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from facedet_tpu_torch.models.init import random_init
from facedet_tpu_torch.models.layers import FlaxBatchNorm2d

__all__ = [
    "RtDetrConfig",
    "RTDETR_VARIANTS",
    "ConvBnRelu",
    "Backbone",
    "sincos_pos_embed_2d",
    "Aifi",
    "Ccff",
    "MsDeformAttn",
    "DecoderLayer",
    "inverse_sigmoid",
    "dn_attention_mask",
    "RtDetr",
    "create_rtdetr",
    "decode_rtdetr",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class RtDetrConfig:
    num_classes: int = 1
    hidden_dim: int = 256
    num_queries: int = 300
    num_heads: int = 8
    num_decoder_layers: int = 6
    num_points: int = 4  # deformable sampling points per head per level
    ffn_dim: int = 1024
    backbone_widths: tuple[int, int, int, int] = (64, 128, 256, 512)
    backbone_depths: tuple[int, int, int, int] = (2, 2, 2, 2)
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


RTDETR_VARIANTS = {
    "rtdetr-l": RtDetrConfig(),
    # mid-capacity preset: enough backbone width to resolve small faces in
    # 480-640px crops while staying cheap enough for from-scratch demos
    "rtdetr-m": RtDetrConfig(
        hidden_dim=128,
        num_queries=120,
        num_heads=8,
        num_decoder_layers=3,
        ffn_dim=512,
        backbone_widths=(16, 32, 64, 128),
        backbone_depths=(1, 2, 2, 1),
    ),
    "rtdetr-tiny": RtDetrConfig(
        hidden_dim=64,
        num_queries=60,
        num_heads=4,
        num_decoder_layers=2,
        ffn_dim=128,
        backbone_widths=(8, 16, 24, 32),
        backbone_depths=(1, 1, 1, 1),
    ),
}


def _in(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv or linear layer in its weight's dtype (flax's ``dtype``)."""
    return m(x.to(m.weight.dtype))


class ConvBnRelu(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, kernel, stride=stride, padding=kernel // 2, bias=False)
        self.BatchNorm_0 = FlaxBatchNorm2d(features)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(_in(self.Conv_0, x).float()))


class Backbone(nn.Module):
    def __init__(self, cfg: RtDetrConfig):
        super().__init__()
        w0 = cfg.backbone_widths[0]
        self.stem0 = ConvBnRelu(3, w0 // 2, 3, 2)
        self.stem1 = ConvBnRelu(w0 // 2, w0, 3, 1)
        self.blocks: list[list[tuple[str, bool]]] = []
        cin = w0
        for stage, (w, d) in enumerate(zip(cfg.backbone_widths, cfg.backbone_depths)):
            names = []
            for i in range(d):
                stride = 2 if i == 0 else 1
                p = f"s{stage}_c{i}"
                setattr(self, p + "a", ConvBnRelu(cin, w, 3, stride))
                setattr(self, p + "b", nn.Conv2d(w, w, 3, padding=1, bias=False))
                setattr(self, p + "bn", FlaxBatchNorm2d(w))
                project = cin != w or stride != 1
                if project:
                    setattr(self, p + "p", nn.Conv2d(cin, w, 1, stride=stride, bias=False))
                    setattr(self, p + "pbn", FlaxBatchNorm2d(w))
                names.append((p, project))
                cin = w
            self.blocks.append(names)

    def forward(self, x):
        x = self.stem1(self.stem0(x))
        outs = []
        for stage, names in enumerate(self.blocks):
            for p, project in names:
                y = getattr(self, p + "a")(x)
                y = getattr(self, p + "bn")(_in(getattr(self, p + "b"), y).float())
                if project:
                    # contiguous: torch's CPU backward of a 1x1 stride-2 conv on a
                    # channels-last input (NHWC images permuted) corrupts the heap,
                    # and on the card cuDNN transposes its layout in training
                    x = getattr(self, p + "pbn")(_in(getattr(self, p + "p"), x.contiguous()).float())
                x = torch.relu(x + y)
            if stage >= 1:
                outs.append(x)
        return outs  # strides 8, 16, 32


def sincos_pos_embed_2d(h: int, w: int, dim: int, temperature: float = 10000.0, device=None) -> torch.Tensor:
    """[h*w, dim] 2D sincos embedding (AIFI positional encoding)."""
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (torch.arange(pos_dim, dtype=torch.float32, device=device) / pos_dim))
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    out_x = xs.reshape(-1, 1) * omega[None]
    out_y = ys.reshape(-1, 1) * omega[None]
    return torch.cat([out_x.sin(), out_x.cos(), out_y.sin(), out_y.cos()], dim=1)


class MultiHeadAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention``: separate query / key / value
    projections and an ``out`` projection, all with bias. ``mask`` is a
    boolean tensor broadcastable to [B, heads, Q, K], True = may attend (the
    flax convention, and the opposite of ``nn.MultiheadAttention``'s)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q_in, k_in, v_in, mask=None):
        b, nq, d = q_in.shape
        nh, dh = self.num_heads, d // self.num_heads

        def heads(m, x):
            return _in(m, x).reshape(b, -1, nh, dh).transpose(1, 2)  # [B, nh, N, dh]

        q, k, v = heads(self.query, q_in), heads(self.key, k_in), heads(self.value, v_in)
        logits = torch.matmul(q * dh**-0.5, k.transpose(-1, -2)).float()
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, nq, d)
        return _in(self.out, out)


class Aifi(nn.Module):
    """One transformer encoder layer on the flattened stride-32 map."""

    def __init__(self, cfg: RtDetrConfig):
        super().__init__()
        c = cfg.hidden_dim
        self.self_attn = MultiHeadAttention(c, cfg.num_heads)
        self.ln1 = nn.LayerNorm(c, eps=1e-6)
        self.ffn0 = nn.Linear(c, cfg.ffn_dim)
        self.ffn1 = nn.Linear(cfg.ffn_dim, c)
        self.ln2 = nn.LayerNorm(c, eps=1e-6)

    def forward(self, x):
        """x [B,C,H,W] -> [B,C,H,W] float32."""
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)  # [B, HW, C]
        pos = sincos_pos_embed_2d(h, w, c, device=x.device).to(self.ffn0.weight.dtype)
        q = tokens + pos[None]
        attn = self.self_attn(q, q, tokens)
        tokens = self.ln1((tokens + attn).float())
        y = _in(self.ffn1, F.gelu(_in(self.ffn0, tokens), approximate="tanh"))
        tokens = self.ln2((tokens + y).float())
        return tokens.transpose(1, 2).reshape(b, c, h, w)


class Ccff(nn.Module):
    """Cross-scale feature fusion (FPN + PAN with conv blocks)."""

    def __init__(self, cfg: RtDetrConfig):
        super().__init__()
        c = cfg.hidden_dim
        for i, w in enumerate(cfg.backbone_widths[1:]):
            setattr(self, f"proj{i}", ConvBnRelu(w, c, 1, 1))
        self.aifi = Aifi(cfg)
        for i in (1, 0):
            setattr(self, f"fuse_td{i}", ConvBnRelu(2 * c, c, 3, 1))
        for i in (1, 2):
            setattr(self, f"down{i}", ConvBnRelu(c, c, 3, 2))
            setattr(self, f"fuse_bu{i}", ConvBnRelu(2 * c, c, 3, 1))

    def forward(self, feats):
        p = [getattr(self, f"proj{i}")(f) for i, f in enumerate(feats)]
        p[2] = self.aifi(p[2])
        for i in (1, 0):  # top-down
            up = F.interpolate(p[i + 1], size=p[i].shape[2:], mode="nearest-exact")
            p[i] = getattr(self, f"fuse_td{i}")(torch.cat([p[i], up], dim=1))
        for i in (1, 2):  # bottom-up
            down = getattr(self, f"down{i}")(p[i - 1])
            p[i] = getattr(self, f"fuse_bu{i}")(torch.cat([p[i], down], dim=1))
        return p


def _bilinear_sample(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """feat [H,W,C], coords [N,2] (x, y) in pixel space -> [N,C], zero
    outside the map. One ``grid_sample`` call: pixel p is the normalised
    coordinate ``(2p + 1)/size - 1`` under ``align_corners=False``."""
    h, w, _ = feat.shape
    size = torch.tensor([w, h], dtype=coords.dtype, device=coords.device)
    grid = (2.0 * coords + 1.0) / size - 1.0
    out = F.grid_sample(
        feat.permute(2, 0, 1)[None], grid[None, :, None, :], mode="bilinear", padding_mode="zeros", align_corners=False
    )  # [1, C, N, 1]
    return out[0, :, :, 0].T


class MsDeformAttn(nn.Module):
    """Multi-scale deformable attention over 3 feature levels."""

    def __init__(self, cfg: RtDetrConfig, num_levels: int = 3):
        super().__init__()
        self.nh, self.npts, self.nl = cfg.num_heads, cfg.num_points, num_levels
        d = cfg.hidden_dim
        self.sampling_offsets = nn.Linear(d, self.nh * self.nl * self.npts * 2)
        self.attention_weights = nn.Linear(d, self.nh * self.nl * self.npts)
        for i in range(num_levels):
            setattr(self, f"value_proj{i}", nn.Linear(d, d))
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, ref_points, value_feats):
        """query [B,Q,D]; ref_points [B,Q,4] cxcywh in [0,1]; value_feats: a
        list of [B,D,Hi,Wi]."""
        nh, npts, nl = self.nh, self.npts, self.nl
        b, q, d = query.shape
        dh = d // nh

        offsets = _in(self.sampling_offsets, query).reshape(b, q, nh, nl, npts, 2)
        weights = _in(self.attention_weights, query).reshape(b, q, nh, nl * npts)
        weights = torch.softmax(weights.float(), dim=-1).reshape(b, q, nh, nl, npts)

        ref_xy = ref_points[..., :2].float()[:, :, None, None, :]
        ref_wh = ref_points[..., 2:].float()[:, :, None, None, :]
        out = torch.zeros((b, nh, dh, q), dtype=torch.float32, device=query.device)
        for li, feat in enumerate(value_feats):
            hgt, wid = feat.shape[2:]
            val = _in(getattr(self, f"value_proj{li}"), feat.flatten(2).transpose(1, 2))  # [B, HW, D]
            # each head samples its own dh channels: [B*nh, dh, H, W]
            val = val.transpose(1, 2).reshape(b * nh, dh, hgt, wid).float()
            # sampling locations, normalised, modulated by the box size
            loc = ref_xy + offsets[:, :, :, li].float() / npts * ref_wh * 0.5  # [B,Q,nh,P,2]
            # pixel loc*size - 0.5 is the normalised coordinate 2*loc - 1
            grid = (2.0 * loc - 1.0).permute(0, 2, 1, 3, 4).reshape(b * nh, q, npts, 2)
            sampled = F.grid_sample(val, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
            w_l = weights[:, :, :, li].permute(0, 2, 1, 3)  # [B, nh, Q, P]
            out = out + (sampled.reshape(b, nh, dh, q, npts) * w_l[:, :, None]).sum(-1)
        out = out.permute(0, 3, 1, 2).reshape(b, q, d)
        return _in(self.output_proj, out)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: RtDetrConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.self_attn = MultiHeadAttention(d, cfg.num_heads)
        self.ln1 = nn.LayerNorm(d, eps=1e-6)
        self.cross_attn = MsDeformAttn(cfg)
        self.ln2 = nn.LayerNorm(d, eps=1e-6)
        self.ffn0 = nn.Linear(d, cfg.ffn_dim)
        self.ffn1 = nn.Linear(cfg.ffn_dim, d)
        self.ln3 = nn.LayerNorm(d, eps=1e-6)

    def forward(self, query, ref_points, feats, query_pos, attn_mask=None):
        q = query + query_pos
        sa = self.self_attn(q, q, query, mask=attn_mask)
        query = self.ln1((query + sa).float())
        ca = self.cross_attn(query + query_pos, ref_points, feats)
        query = self.ln2((query + ca).float())
        y = _in(self.ffn1, torch.relu(_in(self.ffn0, query)))
        return self.ln3((query + y).float())


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def dn_attention_mask(n_dn: int, num_groups: int, num_queries: int, device=None) -> torch.Tensor:
    """Decoder self-attention mask for CDN, [N+K, N+K] (True = may attend):
    matching queries never see denoising ones, denoising group i never sees
    group j != i, and every query sees the matching block."""
    total = n_dn + num_queries
    group = torch.arange(n_dn, device=device) // max(n_dn // num_groups, 1)
    mask = torch.zeros((total, total), dtype=torch.bool, device=device)
    mask[:, n_dn:] = True
    mask[:n_dn, :n_dn] = group[:, None] == group[None, :]
    return mask


class RtDetr(nn.Module):
    """images [B,H,W,3] in [0,1] -> dict with per-layer logits / boxes, the
    encoder outputs and ``top_idx``, the encoder tokens selected as queries;
    with CDN queries also per-layer ``dn_logits`` / ``dn_boxes``."""

    def __init__(self, cfg: RtDetrConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        # the denoising queries' label embedding (training only)
        self.dn_embed = nn.Parameter(torch.zeros(cfg.num_classes + 1, d))
        self.backbone = Backbone(cfg)
        self.encoder = Ccff(cfg)
        self.enc_norm = nn.LayerNorm(d, eps=1e-6)
        self.enc_score = nn.Linear(d, cfg.num_classes)
        self.enc_bbox = nn.Linear(d, 4)
        for li in range(cfg.num_decoder_layers):
            setattr(self, f"qpos{li}", nn.Linear(4, d))
            setattr(self, f"layer{li}", DecoderLayer(cfg))
            setattr(self, f"cls{li}", nn.Linear(d, cfg.num_classes))
            setattr(self, f"box{li}", nn.Linear(d, 4))

    def set_dtypes(self) -> "RtDetr":
        """Cast conv and linear weights to the config's compute dtype; the
        norms and ``dn_embed`` stay float32."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(self.cfg.compute_dtype)
        return self

    def forward(self, x, dn_labels=None, dn_ref=None, dn_groups: int = 0, top_idx=None):
        """x [B,H,W,3] (the flax layout)."""
        return self.forward_nchw(x.permute(0, 3, 1, 2), dn_labels, dn_ref, dn_groups, top_idx)

    def forward_nchw(self, x, dn_labels=None, dn_ref=None, dn_groups: int = 0, top_idx=None):
        """x [B,3,H,W]. ``top_idx`` [B,K] overrides the query selection (to
        compare two runs whose encoder scores differ in the last digits).
        ``dn_labels`` [B,N] (class ids, ``num_classes`` = background) and
        ``dn_ref`` [B,N,4] cxcywh add N denoising queries in ``dn_groups``
        groups."""
        cfg, dt = self.cfg, self.cfg.compute_dtype
        feats = self.encoder(self.backbone(x.to(dt)))
        b = x.shape[0]

        # --- query selection from the flattened encoder tokens ---
        tokens = torch.cat([f.flatten(2).transpose(1, 2) for f in feats], dim=1)
        anchors = []
        for f, stride_frac in zip(feats, (1 / 8, 1 / 16, 1 / 32)):
            hgt, wid = f.shape[2:]
            ys = (torch.arange(hgt, dtype=torch.float32, device=x.device) + 0.5) / hgt
            xs = (torch.arange(wid, dtype=torch.float32, device=x.device) + 0.5) / wid
            yy, xx = torch.meshgrid(ys, xs, indexing="ij")
            wh = torch.full((hgt * wid, 2), 0.05 / stride_frac / 4, dtype=torch.float32, device=x.device)
            anchors.append(torch.cat([torch.stack([xx.reshape(-1), yy.reshape(-1)], -1), wh], -1))
        anchors = torch.cat(anchors, 0)  # [S,4] cxcywh normalised

        enc_tokens = self.enc_norm(tokens.float())
        enc_logits = _in(self.enc_score, enc_tokens)
        enc_delta = _in(self.enc_bbox, enc_tokens)
        enc_boxes = torch.sigmoid(enc_delta.float() + inverse_sigmoid(anchors)[None])

        score = enc_logits.float().max(dim=-1).values
        k = min(cfg.num_queries, score.shape[1])
        if top_idx is None:
            top_idx = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
        take = lambda arr: torch.gather(arr, 1, top_idx[..., None].expand(-1, -1, arr.shape[-1]))
        ref = take(enc_boxes)  # [B,K,4]
        query = take(enc_tokens).to(dt)

        n_dn, attn_mask = 0, None
        if dn_labels is not None:
            n_dn = dn_labels.shape[1]
            query = torch.cat([self.dn_embed[dn_labels.long()].to(dt), query], dim=1)
            ref = torch.cat([dn_ref.float(), ref], dim=1)
            attn_mask = dn_attention_mask(n_dn, max(dn_groups, 1), k, device=x.device)[None, None]

        outputs = {"enc_logits": enc_logits, "enc_boxes": enc_boxes, "top_idx": top_idx}
        layer_logits, layer_boxes, dn_logits, dn_boxes = [], [], [], []
        last = cfg.num_decoder_layers - 1
        for li in range(cfg.num_decoder_layers):
            query_pos = _in(getattr(self, f"qpos{li}"), inverse_sigmoid(ref))
            query = getattr(self, f"layer{li}")(query, ref, feats, query_pos, attn_mask=attn_mask)
            logits = _in(getattr(self, f"cls{li}"), query).float()
            delta = _in(getattr(self, f"box{li}"), query)
            ref = torch.sigmoid(delta.float() + inverse_sigmoid(ref))
            if li < last:
                ref = ref.detach()
            layer_logits.append(logits[:, n_dn:])
            layer_boxes.append(ref[:, n_dn:])
            if n_dn:
                dn_logits.append(logits[:, :n_dn])
                dn_boxes.append(ref[:, :n_dn])
        outputs["logits"] = layer_logits
        outputs["boxes"] = layer_boxes
        if n_dn:
            outputs["dn_logits"] = dn_logits
            outputs["dn_boxes"] = dn_boxes
        return outputs


def decode_rtdetr(outputs: dict, image_size: int) -> dict:
    """Final layer -> flat {boxes [B,Q,4] xyxy px, scores [B,Q,C]} (DETR
    style: no NMS needed). Both axes scale by ``image_size``."""
    logits = outputs["logits"][-1]
    cx, cy, w, h = outputs["boxes"][-1].split(1, dim=-1)  # cxcywh normalised
    xyxy = torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1) * image_size
    return {"boxes": xyxy, "scores": torch.sigmoid(logits)}


def create_rtdetr(cfg: RtDetrConfig, seed: int = 0) -> RtDetr:
    """An ``RtDetr`` with random weights from a seeded ``torch.Generator``
    (made on the CPU: the caller moves it)."""
    model = RtDetr(cfg)
    random_init(model, seed)
    return model.set_dtypes().eval()
