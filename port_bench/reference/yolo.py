"""Plain float32 YOLOv11-pose forward and head decode, over the tensors of a
flax checkpoint (``params/...`` and ``batch_stats/...``, as
``port_bench.weights`` gives them).

Written from the published YOLO11 architecture (Ultralytics
``yolo11-pose.yaml``: CSP backbone of C3k2 blocks, SPPF, C2PSA, PAN neck,
decoupled DFL head with a keypoint branch). The block kind and the channel
counts are read from the checkpoint's kernel shapes, so no size is given
here. Eval-mode BatchNorm with eps 1e-3, as flax's ``nn.BatchNorm``. NCHW
``torch.nn.functional`` calls only; nothing of the program is imported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
STRIDES = (8, 16, 32)
REG_MAX = 16


class Yolo:
    """The checkpoint's forward: ``__call__(x [B,3,H,W] in [0,1])`` -> per
    level {"box", "cls", "kpt"} maps, NHWC float32. ``conv`` may be replaced
    (the FLOP test counts through it)."""

    def __init__(self, params: dict[str, torch.Tensor]):
        self.p = params
        self.conv = F.conv2d

    def has(self, scope: str) -> bool:
        return any(k.startswith(f"params/{scope}/") for k in self.p)

    def kernel(self, scope: str) -> torch.Tensor:
        return self.p[f"params/{scope}/conv/kernel"]

    def cba(self, scope: str, x, stride: int = 1, act: bool = True):
        w = self.kernel(scope)
        groups = x.shape[1] // w.shape[1]
        y = self.conv(x, w, None, stride, w.shape[-1] // 2, 1, groups)
        mean = self.p[f"batch_stats/{scope}/bn/mean"]
        var = self.p[f"batch_stats/{scope}/bn/var"]
        scale = self.p[f"params/{scope}/bn/scale"]
        bias = self.p[f"params/{scope}/bn/bias"]
        y = (y - mean[:, None, None]) * (scale / torch.sqrt(var + BN_EPS))[:, None, None] + bias[:, None, None]
        return F.silu(y) if act else y

    def plain_conv(self, scope: str, x):
        w = self.p[f"params/{scope}/kernel"]
        return self.conv(x, w, self.p[f"params/{scope}/bias"], 1, w.shape[-1] // 2)

    def bottleneck(self, scope: str, x):
        y = self.cba(f"{scope}/cv2", self.cba(f"{scope}/cv1", x))
        return x + y if y.shape[1] == x.shape[1] else y

    def _inner(self, scope: str):
        n = 0
        while self.has(f"{scope}/m{n}"):
            n += 1
        return [f"{scope}/m{i}" for i in range(n)]

    def c3k(self, scope: str, x):
        a = self.cba(f"{scope}/cv1", x)
        for m in self._inner(scope):
            a = self.bottleneck(m, a)
        return self.cba(f"{scope}/cv3", torch.cat([a, self.cba(f"{scope}/cv2", x)], 1))

    def c3k2(self, scope: str, x):
        y = self.cba(f"{scope}/cv1", x)
        half = y.shape[1] // 2
        parts = [y[:, :half], y[:, half:]]
        for m in self._inner(scope):
            block = self.c3k if self.has(f"{m}/cv3") else self.bottleneck
            parts.append(block(m, parts[-1]))
        return self.cba(f"{scope}/cv2", torch.cat(parts, 1))

    def sppf(self, scope: str, x):
        outs = [self.cba(f"{scope}/cv1", x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], 5, stride=1, padding=2))
        return self.cba(f"{scope}/cv2", torch.cat(outs, 1))

    def attention(self, scope: str, x):
        b, dim, h, w = x.shape
        heads = max(1, dim // 64)
        head_dim = dim // heads
        kd = (self.kernel(f"{scope}/qkv").shape[0] - dim) // (2 * heads)
        qkv = self.cba(f"{scope}/qkv", x, act=False).reshape(b, heads, 2 * kd + head_dim, h * w)
        q, k, v = qkv[:, :, :kd], qkv[:, :, kd:2 * kd], qkv[:, :, 2 * kd:]
        attn = torch.softmax(torch.matmul(q.transpose(-1, -2), k) * kd**-0.5, dim=-1)
        out = torch.matmul(v, attn.transpose(-1, -2)).reshape(b, dim, h, w)
        out = out + self.cba(f"{scope}/pe", v.reshape(b, dim, h, w), act=False)
        return self.cba(f"{scope}/proj", out, act=False)

    def c2psa(self, scope: str, x):
        y = self.cba(f"{scope}/cv1", x)
        half = y.shape[1] // 2
        a, b = y[:, :half], y[:, half:]
        for m in self._inner(scope):
            b = b + self.attention(f"{m}/attn", b)
            b = b + self.cba(f"{m}/ffn1", self.cba(f"{m}/ffn0", b), act=False)
        return self.cba(f"{scope}/cv2", torch.cat([a, b], 1))

    def __call__(self, x):
        bb = "backbone"
        x = self.cba(f"{bb}/stem", x, 2)
        x = self.cba(f"{bb}/down1", x, 2)
        x = self.c3k2(f"{bb}/c3k2_0", x)
        x = self.cba(f"{bb}/down2", x, 2)
        p3 = self.c3k2(f"{bb}/c3k2_1", x)
        x = self.cba(f"{bb}/down3", p3, 2)
        p4 = self.c3k2(f"{bb}/c3k2_2", x)
        x = self.cba(f"{bb}/down4", p4, 2)
        x = self.c3k2(f"{bb}/c3k2_3", x)
        p5 = self.c2psa(f"{bb}/c2psa", self.sppf(f"{bb}/sppf", x))
        up = lambda t: t.repeat_interleave(2, 2).repeat_interleave(2, 3)  # noqa: E731
        n4 = self.c3k2("neck/up0", torch.cat([up(p5), p4], 1))
        n3 = self.c3k2("neck/up1", torch.cat([up(n4), p3], 1))
        m4 = self.c3k2("neck/pan0", torch.cat([self.cba("neck/down0", n3, 2), n4], 1))
        m5 = self.c3k2("neck/pan1", torch.cat([self.cba("neck/down1", m4, 2), p5], 1))
        levels = []
        for i, f in enumerate((n3, m4, m5)):
            box = self.plain_conv(f"head/box{i}_2", self.cba(f"head/box{i}_1", self.cba(f"head/box{i}_0", f)))
            c = f
            for part in ("dw0", "pw0", "dw1", "pw1"):
                c = self.cba(f"head/cls{i}_{part}", c)
            cls = self.plain_conv(f"head/cls{i}_out", c)
            kpt = self.plain_conv(f"head/kpt{i}_2", self.cba(f"head/kpt{i}_1", self.cba(f"head/kpt{i}_0", f)))
            levels.append({k: v.permute(0, 2, 3, 1) for k, v in (("box", box), ("cls", cls), ("kpt", kpt))})
        return levels


def decode(levels) -> dict[str, torch.Tensor]:
    """Per-level maps -> per-anchor boxes [B, A, 4] xyxy (input pixels), the
    best class score [B, A] and keypoints [B, A, K, 3]."""
    boxes, scores, kpts = [], [], []
    for level, stride in zip(levels, STRIDES):
        b, h, w, _ = level["box"].shape
        dev = level["box"].device
        ys, xs = torch.meshgrid(torch.arange(h, device=dev) + 0.5, torch.arange(w, device=dev) + 0.5, indexing="ij")
        anchors = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()
        dist = torch.softmax(level["box"].reshape(b, h * w, 4, REG_MAX), -1)
        dist = (dist * torch.arange(REG_MAX, device=dev, dtype=torch.float32)).sum(-1)
        boxes.append(torch.cat([anchors - dist[..., :2], anchors + dist[..., 2:]], -1) * stride)
        scores.append(torch.sigmoid(level["cls"].reshape(b, h * w, -1)).amax(-1))
        km = level["kpt"].reshape(b, h * w, -1, 3)
        kxy = (km[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * stride
        kpts.append(torch.cat([kxy, torch.sigmoid(km[..., 2:3])], -1))
    return {"boxes": torch.cat(boxes, 1), "scores": torch.cat(scores, 1), "kpts": torch.cat(kpts, 1)}
