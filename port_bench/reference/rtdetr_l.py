"""Plain float32 RT-DETR-l forward and per-tile detections, over tensors
named as Ultralytics names them (``model.0.stem1.conv.weight`` ...
``model.28.dec_bbox_head.5.layers.2.bias``).

Written from the published architecture (Ultralytics ``rtdetr-l.yaml``,
``block.py``'s ``HGStem``, ``HGBlock``, ``LightConv``, ``RepC3``,
``RepConv``, ``transformer.py``'s ``AIFI``, ``MSDeformAttn``,
``DeformableTransformerDecoderLayer`` and ``head.py``'s ``RTDETRDecoder``;
Lv et al., arXiv:2304.08069), ``torch.nn.functional`` calls only, nothing of
the program or of JAX imported. The channel counts, the convolutions of a
block and the decoder's depth are read from the tensors' shapes and names;
the heads (8) and the queries (300) are given. Eval-mode BatchNorm with eps
1e-3 (Ultralytics' ``initialize_weights``), LayerNorm eps 1e-5, exact GELU,
``inverse_sigmoid`` with eps 1e-5, the sin-cos embedding in
``build_2d_sincos_position_embedding``'s own (w-major) order, ``torch.topk``
for the query selection, evaluation at the last decoder layer. No departure
from Ultralytics is known.

The repository keeps two copies of this file, ``port_bench/reference/
rtdetr_l.py`` (the benchmark's) and ``tests/plain_rtdetr_l.py`` (the CPU
tests'); a test holds them to the same answers bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
LN_EPS = 1e-5
LEVELS = 3
DECODER = "model.28"
# (index of each HGBlock, whether it adds its input); the DWConvs between
# the stages are model.2, model.4 and model.8
BLOCKS = ((1, False), (3, False), (5, False), (6, True), (7, True), (9, False))


class RtDetrL:
    """``__call__(x [B,3,H,W] in [0, 1], top_idx=None)`` -> {"logits" [B,Q,nc],
    "boxes" [B,Q,4] cxcywh in [0, 1], "top_idx" [B,Q], "enc_scores" [B,S,nc]}.
    ``conv`` and ``linear`` may be replaced (a count of operations goes
    through them)."""

    def __init__(self, params: dict[str, torch.Tensor], num_heads: int = 8, num_queries: int = 300):
        self.p = params
        self.nh, self.nq = num_heads, num_queries
        self.conv = F.conv2d
        self.linear = F.linear

    # --- convolutions --------------------------------------------------------------

    def cba(self, scope: str, x, stride: int = 1, act: str = "relu", padding=None):
        """Conv (no bias), BatchNorm, then ``relu``, ``silu`` or ``none``."""
        w = self.p[f"{scope}.conv.weight"]
        groups = x.shape[1] // w.shape[1]
        y = self.conv(x, w, None, stride, w.shape[-1] // 2 if padding is None else padding, 1, groups)
        y = self.bn(f"{scope}.bn", y)
        if act == "relu":
            return F.relu(y)
        return F.silu(y) if act == "silu" else y

    def bn(self, scope: str, y):
        mean, var = self.p[f"{scope}.running_mean"], self.p[f"{scope}.running_var"]
        scale, bias = self.p[f"{scope}.weight"], self.p[f"{scope}.bias"]
        return (y - mean[:, None, None]) * (scale / torch.sqrt(var + BN_EPS))[:, None, None] + bias[:, None, None]

    def stem(self, x):
        s = "model.0"
        x = F.pad(self.cba(f"{s}.stem1", x, 2), (0, 1, 0, 1))
        x2 = self.cba(f"{s}.stem2a", x, padding=0)
        x2 = self.cba(f"{s}.stem2b", F.pad(x2, (0, 1, 0, 1)), padding=0)
        x1 = F.max_pool2d(x, 2, stride=1, ceil_mode=True)
        return self.cba(f"{s}.stem4", self.cba(f"{s}.stem3", torch.cat([x1, x2], dim=1), 2))

    def hgblock(self, index: int, x, shortcut: bool):
        scope = f"model.{index}"
        n = 0
        while f"{scope}.m.{n}.conv.weight" in self.p or f"{scope}.m.{n}.conv1.conv.weight" in self.p:
            n += 1
        ys = [x]
        for i in range(n):
            m = f"{scope}.m.{i}"
            if f"{m}.conv1.conv.weight" in self.p:  # LightConv: 1x1 with no act, then depthwise with ReLU
                ys.append(self.cba(f"{m}.conv2", self.cba(f"{m}.conv1", ys[-1], act="none")))
            else:
                ys.append(self.cba(m, ys[-1]))
        y = self.cba(f"{scope}.ec", self.cba(f"{scope}.sc", torch.cat(ys, dim=1)))
        return y + x if shortcut and y.shape[1] == x.shape[1] else y

    def repc3(self, index: int, x):
        scope = f"model.{index}"
        y = self.cba(f"{scope}.cv1", x, act="silu")
        i = 0
        while f"{scope}.m.{i}.conv1.conv.weight" in self.p:
            m = f"{scope}.m.{i}"
            y = F.silu(self.cba(f"{m}.conv1", y, act="none") + self.cba(f"{m}.conv2", y, act="none"))
            i += 1
        return y + self.cba(f"{scope}.cv2", x, act="silu")

    def backbone(self, x):
        """(P3, P4, P5)."""
        x = self.stem(x)
        outs = {}
        for index, shortcut in BLOCKS:
            if index in (3, 5, 9):
                x = self.cba(f"model.{index - 1}", x, 2, act="none")  # DWConv
            x = self.hgblock(index, x, shortcut)
            outs[index] = x
        return outs[3], outs[7], outs[9]

    # --- attention -----------------------------------------------------------------

    def lin(self, scope: str, x):
        return self.linear(x, self.p[f"{scope}.weight"], self.p[f"{scope}.bias"])

    def ln(self, scope: str, x):
        return F.layer_norm(x, (x.shape[-1],), self.p[f"{scope}.weight"], self.p[f"{scope}.bias"], LN_EPS)

    def mha(self, scope: str, q_in, k_in, v_in):
        """``nn.MultiheadAttention`` with no mask, batch first."""
        b, nq, d = q_in.shape
        nh, dh = self.nh, d // self.nh
        w, bias = self.p[f"{scope}.in_proj_weight"], self.p[f"{scope}.in_proj_bias"]
        q, k, v = (self.linear(t, w[i * d:(i + 1) * d], bias[i * d:(i + 1) * d]).reshape(b, -1, nh, dh).transpose(1, 2)
                   for i, t in enumerate((q_in, k_in, v_in)))
        attn = torch.softmax(torch.matmul(q * dh**-0.5, k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, nq, d)
        return self.lin(f"{scope}.out_proj", out)

    def mlp(self, scope: str, x):
        i = 0
        while f"{scope}.layers.{i + 1}.weight" in self.p:
            x = F.relu(self.lin(f"{scope}.layers.{i}", x))
            i += 1
        return self.lin(f"{scope}.layers.{i}", x)

    @staticmethod
    def sincos(w: int, h: int, dim: int, device, temperature: float = 10000.0):
        """``AIFI.build_2d_sincos_position_embedding`` as published: the
        meshgrid of (w, h) with ``indexing="ij"``, flattened w-major."""
        grid_w, grid_h = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=device),
                                        torch.arange(h, dtype=torch.float32, device=device), indexing="ij")
        pos_dim = dim // 4
        omega = 1.0 / (temperature ** (torch.arange(pos_dim, dtype=torch.float32, device=device) / pos_dim))
        out_w = grid_w.flatten()[:, None] * omega[None]
        out_h = grid_h.flatten()[:, None] * omega[None]
        return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], dim=1)

    def aifi(self, x):
        s = "model.11"
        b, c, h, w = x.shape
        src = x.flatten(2).transpose(1, 2)
        q = src + self.sincos(w, h, c, x.device)[None]
        src = self.ln(f"{s}.norm1", src + self.mha(f"{s}.ma", q, q, src))
        y = self.lin(f"{s}.fc2", F.gelu(self.lin(f"{s}.fc1", src)))
        src = self.ln(f"{s}.norm2", src + y)
        return src.transpose(1, 2).reshape(b, c, h, w)

    def encoder(self, p3, p4, p5):
        """(X3, F4, F5) of the hybrid encoder."""
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        y5 = self.cba("model.12", self.aifi(self.cba("model.10", p5, act="none")), act="silu")
        y4 = self.cba("model.17", self.repc3(16, torch.cat([up(y5), self.cba("model.14", p4, act="none")], 1)),
                      act="silu")
        x3 = self.repc3(21, torch.cat([up(y4), self.cba("model.19", p3, act="none")], 1))
        f4 = self.repc3(24, torch.cat([self.cba("model.22", x3, 2, act="silu"), y4], 1))
        f5 = self.repc3(27, torch.cat([self.cba("model.25", f4, 2, act="silu"), y5], 1))
        return x3, f4, f5

    def deform(self, scope: str, query, ref, value, shapes):
        """``MSDeformAttn`` with 4-d reference boxes, its sampling written as
        ``multi_scale_deformable_attn_pytorch``."""
        b, nq, d = query.shape
        nh, dh = self.nh, d // self.nh
        v = self.lin(f"{scope}.value_proj", value)
        weights = self.lin(f"{scope}.attention_weights", query)
        npts = weights.shape[-1] // (nh * LEVELS)
        off = self.lin(f"{scope}.sampling_offsets", query).reshape(b, nq, nh, LEVELS, npts, 2)
        weights = torch.softmax(weights.reshape(b, nq, nh, LEVELS * npts), dim=-1)
        loc = ref[:, :, None, None, None, :2] + off / npts * ref[:, :, None, None, None, 2:] * 0.5
        grids = 2 * loc - 1
        sampled, start = [], 0
        for level, (h, w) in enumerate(shapes):
            v_l = v[:, start:start + h * w].transpose(1, 2).reshape(b * nh, dh, h, w)
            start += h * w
            grid = grids[:, :, :, level].transpose(1, 2).flatten(0, 1)
            sampled.append(F.grid_sample(v_l, grid, mode="bilinear", padding_mode="zeros", align_corners=False))
        weights = weights.transpose(1, 2).reshape(b * nh, 1, nq, LEVELS * npts)
        out = (torch.stack(sampled, dim=-2).flatten(-2) * weights).sum(-1).reshape(b, d, nq).transpose(1, 2)
        return self.lin(f"{scope}.output_proj", out)

    @staticmethod
    def inverse_sigmoid(x, eps: float = 1e-5):
        x = x.clamp(min=0, max=1)
        return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))

    @staticmethod
    def anchors(shapes, device, grid_size: float = 0.05, eps: float = 1e-2):
        out = []
        for i, (h, w) in enumerate(shapes):
            gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                    torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
            xy = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], dim=-1).reshape(h * w, 2)
            out.append(torch.cat([xy, torch.ones_like(xy) * grid_size * (2.0**i)], dim=-1))
        a = torch.cat(out, dim=0)
        valid = ((a > eps) & (a < 1 - eps)).all(-1, keepdim=True)
        return torch.log(a / (1 - a)).masked_fill(~valid, float("inf")), valid

    def decoder(self, feats, top_idx=None):
        s = DECODER
        proj = []
        for i, f in enumerate(feats):
            y = self.conv(f, self.p[f"{s}.input_proj.{i}.0.weight"])
            proj.append(self.bn(f"{s}.input_proj.{i}.1", y))
        shapes = [tuple(f.shape[2:]) for f in proj]
        # the decoder's value is the projected tokens themselves; enc_output
        # (on the masked tokens) feeds the scores, the selection and the queries
        tokens = torch.cat([f.flatten(2).transpose(1, 2) for f in proj], dim=1)
        anchors, valid = self.anchors(shapes, tokens.device)
        memory = self.ln(f"{s}.enc_output.1", self.lin(f"{s}.enc_output.0", valid * tokens))
        enc_scores = self.lin(f"{s}.enc_score_head", memory)
        if top_idx is None:
            top_idx = torch.topk(enc_scores.max(-1).values, self.nq, dim=1).indices
        embed = torch.stack([memory[i, top_idx[i]] for i in range(memory.shape[0])])
        ref = torch.sigmoid(self.mlp(f"{s}.enc_bbox_head", embed) + anchors[top_idx])
        n = 0
        while f"{s}.decoder.layers.{n}.norm1.weight" in self.p:
            n += 1
        for i in range(n):
            layer = f"{s}.decoder.layers.{i}"
            pos = self.mlp(f"{s}.query_pos_head", ref)
            q = embed + pos
            embed = self.ln(f"{layer}.norm1", embed + self.mha(f"{layer}.self_attn", q, q, embed))
            embed = self.ln(f"{layer}.norm2", embed + self.deform(f"{layer}.cross_attn", embed + pos, ref, tokens, shapes))
            y = self.lin(f"{layer}.linear2", F.relu(self.lin(f"{layer}.linear1", embed)))
            embed = self.ln(f"{layer}.norm3", embed + y)
            ref = torch.sigmoid(self.mlp(f"{s}.dec_bbox_head.{i}", embed) + self.inverse_sigmoid(ref))
        logits = self.lin(f"{s}.dec_score_head.{n - 1}", embed)
        return {"logits": logits, "boxes": ref, "top_idx": top_idx, "enc_scores": enc_scores}

    def __call__(self, x, top_idx=None):
        return self.decoder(self.encoder(*self.backbone(x)), top_idx)


def tile_detections(net: RtDetrL, tiles: torch.Tensor, conf: float, top_k: int = 300, top_idx=None) -> list[dict]:
    """Per tile [B,3,h,w]: the detections scoring at least ``conf`` among the
    ``top_k`` best by a stable descending sort, boxes xyxy in tile pixels (both
    axes scaled by the tile height), zero keypoints; numpy {boxes, scores,
    kpts}. No NMS (set predictions)."""
    out = net(tiles, top_idx)
    cx, cy, w, h = out["boxes"].split(1, dim=-1)
    boxes = (torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1) * tiles.shape[2]).cpu().numpy()
    scores = torch.sigmoid(out["logits"]).max(-1).values.cpu().numpy()
    dets = []
    for b in range(tiles.shape[0]):
        order = np.argsort(-scores[b], kind="stable")[:top_k]
        order = order[scores[b][order] >= conf]
        dets.append({"boxes": boxes[b][order], "scores": scores[b][order],
                     "kpts": np.zeros((len(order), 5, 3), np.float32)})
    return dets


def state_shapes(num_classes: int = 1, stem=(32, 48), stage_mid=(48, 96, 192, 384), stage_out=(128, 512, 1024, 2048),
                 block_layers: int = 6, hidden_dim: int = 256, ffn_dim: int = 1024, repc3_depth: int = 3,
                 num_decoder_layers: int = 6, num_heads: int = 8, num_points: int = 4) -> dict[str, tuple]:
    """{Ultralytics name: shape} of every tensor of RT-DETR-l at these widths
    (the defaults are the published ones), BatchNorm step counters left out:
    the layout of ``rtdetr-l.yaml``, written out."""
    s: dict[str, tuple] = {}

    def conv(scope, cin, cout, k, groups=1):
        s[f"{scope}.conv.weight"] = (cout, cin // groups, k, k)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            s[f"{scope}.bn.{leaf}"] = (cout,)

    def linear(scope, cin, cout):
        s[f"{scope}.weight"], s[f"{scope}.bias"] = (cout, cin), (cout,)

    def norm(scope, c):
        s[f"{scope}.weight"], s[f"{scope}.bias"] = (c,), (c,)

    def attention(scope, d):
        s[f"{scope}.in_proj_weight"], s[f"{scope}.in_proj_bias"] = (3 * d, d), (3 * d,)
        linear(f"{scope}.out_proj", d, d)

    def repc3(scope, c1, c2):
        conv(f"{scope}.cv1", c1, c2, 1)
        conv(f"{scope}.cv2", c1, c2, 1)
        for i in range(repc3_depth):
            conv(f"{scope}.m.{i}.conv1", c2, c2, 3)
            conv(f"{scope}.m.{i}.conv2", c2, c2, 1)

    cm, c2 = stem
    for name, (cin, cout, k) in {"stem1": (3, cm, 3), "stem2a": (cm, cm // 2, 2), "stem2b": (cm // 2, cm, 2),
                                 "stem3": (2 * cm, cm, 3), "stem4": (cm, c2, 1)}.items():
        conv(f"model.0.{name}", cin, cout, k)
    cin = c2
    stage_of = {1: 0, 3: 1, 5: 2, 6: 2, 7: 2, 9: 3}
    for index, _ in BLOCKS:
        stage = stage_of[index]
        mid, cout, k, light = stage_mid[stage], stage_out[stage], (3, 3, 5, 5)[stage], stage >= 2
        if index in (3, 5, 9):
            conv(f"model.{index - 1}", cin, cin, 3, groups=cin)
        c = cin
        for i in range(block_layers):
            if light:
                conv(f"model.{index}.m.{i}.conv1", c, mid, 1)
                conv(f"model.{index}.m.{i}.conv2", mid, mid, k, groups=mid)
            else:
                conv(f"model.{index}.m.{i}", c, mid, k)
            c = mid
        conv(f"model.{index}.sc", cin + block_layers * mid, cout // 2, 1)
        conv(f"model.{index}.ec", cout // 2, cout, 1)
        cin = cout
    d = hidden_dim
    conv("model.10", stage_out[3], d, 1)
    attention("model.11.ma", d)
    linear("model.11.fc1", d, ffn_dim)
    linear("model.11.fc2", ffn_dim, d)
    norm("model.11.norm1", d)
    norm("model.11.norm2", d)
    conv("model.12", d, d, 1)
    conv("model.14", stage_out[2], d, 1)
    repc3("model.16", 2 * d, d)
    conv("model.17", d, d, 1)
    conv("model.19", stage_out[1], d, 1)
    repc3("model.21", 2 * d, d)
    conv("model.22", d, d, 3)
    repc3("model.24", 2 * d, d)
    conv("model.25", d, d, 3)
    repc3("model.27", 2 * d, d)
    s_ = DECODER
    for i in range(LEVELS):
        s[f"{s_}.input_proj.{i}.0.weight"] = (d, d, 1, 1)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            s[f"{s_}.input_proj.{i}.1.{leaf}"] = (d,)
    for i in range(num_decoder_layers):
        layer = f"{s_}.decoder.layers.{i}"
        attention(f"{layer}.self_attn", d)
        norm(f"{layer}.norm1", d)
        linear(f"{layer}.cross_attn.sampling_offsets", d, num_heads * LEVELS * num_points * 2)
        linear(f"{layer}.cross_attn.attention_weights", d, num_heads * LEVELS * num_points)
        linear(f"{layer}.cross_attn.value_proj", d, d)
        linear(f"{layer}.cross_attn.output_proj", d, d)
        norm(f"{layer}.norm2", d)
        linear(f"{layer}.linear1", d, ffn_dim)
        linear(f"{layer}.linear2", ffn_dim, d)
        norm(f"{layer}.norm3", d)
    s[f"{s_}.denoising_class_embed.weight"] = (num_classes, d)
    linear(f"{s_}.query_pos_head.layers.0", 4, 2 * d)
    linear(f"{s_}.query_pos_head.layers.1", 2 * d, d)
    linear(f"{s_}.enc_output.0", d, d)
    norm(f"{s_}.enc_output.1", d)
    linear(f"{s_}.enc_score_head", d, num_classes)
    for j, (a, b) in enumerate(((d, d), (d, d), (d, 4))):
        linear(f"{s_}.enc_bbox_head.layers.{j}", a, b)
    for i in range(num_decoder_layers):
        linear(f"{s_}.dec_score_head.{i}", d, num_classes)
        for j, (a, b) in enumerate(((d, d), (d, d), (d, 4))):
            linear(f"{s_}.dec_bbox_head.{i}.layers.{j}", a, b)
    return s
