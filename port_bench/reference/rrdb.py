"""Plain float32 Real-ESRGAN RRDBNet (xinntao/Real-ESRGAN, ``RRDBNet_arch``)
read straight from a flax checkpoint, and its tiled execution.

Net: pixel-unshuffle by 2 for the x2 model (output channel ``(fy*2 + fx)*3
+ c``, the flax net's order), ``conv_first``, 23 RRDBs of three residual
dense blocks (five 3x3 convs, growth 32, LeakyReLU 0.2, residual scale
0.2), ``conv_body``, two nearest 2x upsamplings each followed by a conv and
LeakyReLU, ``conv_hr`` + LeakyReLU, ``conv_last``; output clipped to [0, 1].

Tiling, as the program's enhancer documents it (``plan_tile_grid``): the
fewest and cheapest per-axis tiles (sides rounded up to multiples of 8)
whose halo windows (``tile_pad`` each side where an axis is cut) fit a
budget of 8 windows of (tile + 2 tile_pad)^2 pixels per call; an image that
fits runs whole. The image is reflect-padded to the grid, each window run
alone, and the cores stitched. Nothing of the program is imported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


class RRDB:
    def __init__(self, params: dict[str, torch.Tensor], scale: int = 2, blocks: int = 23):
        self.p, self.scale, self.blocks = params, scale, blocks
        self.conv = F.conv2d

    def c(self, name: str, x):
        return self.conv(x, self.p[f"params/{name}/kernel"], self.p[f"params/{name}/bias"], 1, 1)

    def rdb(self, scope: str, x):
        feats = [x]
        for i in range(1, 5):
            feats.append(F.leaky_relu(self.c(f"{scope}/conv{i}", torch.cat(feats, 1)), 0.2))
        return x + 0.2 * self.c(f"{scope}/conv5", torch.cat(feats, 1))

    def __call__(self, x):
        """x [B, 3, h, w] in [0, 1] -> [B, 3, h*scale, w*scale] in [0, 1]."""
        f = {2: 2, 1: 4}.get(self.scale, 1)
        if f > 1:
            b, c, h, w = x.shape
            x = x.reshape(b, c, h // f, f, w // f, f).permute(0, 3, 5, 1, 2, 4).reshape(b, c * f * f, h // f, w // f)
        feat = self.c("conv_first", x)
        body = feat
        for i in range(self.blocks):
            y = body
            for r in ("rdb1", "rdb2", "rdb3"):
                y = self.rdb(f"body{i}/{r}", y)
            body = body + 0.2 * y
        feat = feat + self.c("conv_body", body)
        for name in ("conv_up1", "conv_up2"):
            feat = F.leaky_relu(self.c(name, feat.repeat_interleave(2, 2).repeat_interleave(2, 3)), 0.2)
        feat = F.leaky_relu(self.c("conv_hr", feat), 0.2)
        return self.c("conv_last", feat).clamp(0.0, 1.0)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def plan(h: int, w: int, tile: int, pad: int, per_call: int = 8):
    """(rows, cols, tile_h, tile_w) of the cheapest grid within the budget."""
    budget = per_call * (tile + 2 * pad) ** 2
    best = None
    for gh in range(1, max(1, -(-h // 64)) + 1):
        th = h if gh == 1 else _ceil_to(-(-h // gh), 8)
        win_h = th + (2 * pad if gh > 1 else 0)
        for gw in range(1, max(1, -(-w // 64)) + 1):
            tw = w if gw == 1 else _ceil_to(-(-w // gw), 8)
            win_w = tw + (2 * pad if gw > 1 else 0)
            chunk = min(per_call, gh * gw)
            if chunk * win_h * win_w > budget:
                continue
            key = (-(-(gh * gw) // chunk) * chunk * win_h * win_w, gh * gw, abs(win_h - win_w))
            if best is None or key < best[0]:
                best = (key, (gh, gw, th, tw))
    return best[1] if best else (-(-h // tile), -(-w // tile), tile, tile)


def _reflect(n: int, before: int, after: int, device) -> torch.Tensor:
    pos = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(pos)
    m = pos % (2 * (n - 1))
    return torch.where(m < n, m, 2 * (n - 1) - m)


def tiled(net: RRDB, image: torch.Tensor, tile: int = 400, pad: int = 10) -> torch.Tensor:
    """[3, H, W] in [0, 1] -> [3, H*s, W*s] by the tile plan."""
    s = net.scale
    h, w = image.shape[1:]
    gh, gw, th, tw = plan(h, w, tile, pad)
    if gh == 1 and gw == 1 and th == h and tw == w:
        return net(image[None])[0]
    py, px = (pad if gh > 1 else 0), (pad if gw > 1 else 0)
    padded = image.index_select(1, _reflect(h, py, gh * th - h + py, image.device))
    padded = padded.index_select(2, _reflect(w, px, gw * tw - w + px, image.device))
    out = torch.zeros((3, gh * th * s, gw * tw * s), dtype=torch.float32, device=image.device)
    for i in range(gh):
        for j in range(gw):
            win = padded[:, i * th:i * th + th + 2 * py, j * tw:j * tw + tw + 2 * px]
            core = net(win[None])[0][:, py * s:py * s + th * s, px * s:px * s + tw * s]
            out[:, i * th * s:(i + 1) * th * s, j * tw * s:(j + 1) * tw * s] = core
    return out[:, :h * s, :w * s]


def int8_conv(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    """``F.conv2d`` on int8 values: the weights quantised symmetrically per
    output channel, the input per tensor (absmax / 127), the products summed
    and scaled back; the bias stays float. The check's control computes the
    enhancer so, one precision below the configuration's bfloat16."""
    sw = w.abs().amax(dim=(1, 2, 3), keepdim=True).clamp(min=1e-12) / 127.0
    sx = x.abs().amax().clamp(min=1e-12) / 127.0
    return F.conv2d(torch.round(x / sx), torch.round(w / sw), None, stride, padding, dilation, groups) * (
        sx * sw.reshape(1, -1, 1, 1)) + (0.0 if b is None else b.reshape(1, -1, 1, 1))


class Enhancer:
    """The reference net in the program's enhancer's place
    (``enhance_array``, ``outscale``, ``device``): the check's control."""

    def __init__(self, net: RRDB, outscale: float, tile: int, tile_pad: int, device):
        self.net, self.outscale, self.tile, self.tile_pad = net, float(outscale), tile, tile_pad
        self.device = torch.device(device)

    @torch.inference_mode()
    def enhance_array(self, image: torch.Tensor, outscale=None) -> torch.Tensor:
        chw = image.to(self.device, torch.float32).permute(2, 0, 1)
        return tiled(self.net, chw, self.tile, self.tile_pad).permute(1, 2, 0)
