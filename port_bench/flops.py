"""Model FLOPs from shapes, two per multiply-add of every convolution and
matrix product (no bias, normalisation or activation), for the per-layer
``mfu`` metrics.

``yolo11_pose_flops`` walks the published YOLO11 layout (Ultralytics
``yolo11-pose.yaml``: channels ``make_divisible(min(c, max_channels) *
width, 8)``, repeats ``max(1, round(n * depth))``) with a 1-class face head
and 5 keypoints; ``rrdb_flops`` the Real-ESRGAN RRDBNet. Both are checked
against a count of the frozen reference forwards in
``tests/test_port_bench_counts.py``.
"""
from __future__ import annotations

# published YOLO11 scales: depth multiple, width multiple, max channels
SCALES = {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024), "m": (0.50, 1.00, 512),
          "l": (1.00, 1.00, 512), "x": (1.00, 1.50, 512)}


def _divisible(x: float, d: int = 8) -> int:
    return max(d, int(x + d / 2) // d * d)


class _Count:
    def __init__(self):
        self.macs = 0

    def conv(self, h: int, w: int, cin: int, cout: int, k: int = 1, groups: int = 1) -> None:
        self.macs += h * w * cout * (cin // groups) * k * k


def _bottleneck(c: _Count, h, w, cin, cout, e):
    hidden = int(cout * e)
    c.conv(h, w, cin, hidden, 3)
    c.conv(h, w, hidden, cout, 3)


def _c3k(c: _Count, h, w, cin, cout, n=2):
    hidden = int(cout * 0.5)
    c.conv(h, w, cin, hidden)
    c.conv(h, w, cin, hidden)
    for _ in range(n):
        _bottleneck(c, h, w, hidden, hidden, 1.0)
    c.conv(h, w, 2 * hidden, cout)


def _c3k2(c: _Count, h, w, cin, cout, n, c3k, e=0.5):
    hidden = int(cout * e)
    c.conv(h, w, cin, 2 * hidden)
    for _ in range(n):
        if c3k:
            _c3k(c, h, w, hidden, hidden)
        else:
            _bottleneck(c, h, w, hidden, hidden, 0.5)
    c.conv(h, w, (2 + n) * hidden, cout)


def yolo11_pose_flops(h: int, w: int, scale: str = "n", num_classes: int = 1, num_keypoints: int = 5) -> float:
    """FLOPs of one forward of an ``h`` x ``w`` image (sides multiples of 32)."""
    depth, width, max_ch = SCALES[scale]
    ch = lambda x: _divisible(min(x, max_ch) * width)  # noqa: E731
    d = max(1, round(2 * depth))
    big = scale in ("m", "l", "x")
    c = _Count()
    r = lambda s: (h // s, w // s)  # noqa: E731
    c.conv(*r(2), 3, ch(64), 3)
    c.conv(*r(4), ch(64), ch(128), 3)
    _c3k2(c, *r(4), ch(128), ch(256), d, False, 0.25)
    c.conv(*r(8), ch(256), ch(256), 3)
    _c3k2(c, *r(8), ch(256), ch(512), d, False, 0.25)
    c.conv(*r(16), ch(512), ch(512), 3)
    _c3k2(c, *r(16), ch(512), ch(512), d, True)
    c.conv(*r(32), ch(512), ch(1024), 3)
    _c3k2(c, *r(32), ch(1024), ch(1024), d, True)
    c.conv(*r(32), ch(1024), ch(1024) // 2)  # SPPF
    c.conv(*r(32), 4 * (ch(1024) // 2), ch(1024))
    # C2PSA: cv1, then per block attention (qkv, q^T k, v attn^T, pe, proj) and the FFN, then cv2
    hid = ch(1024) // 2
    c.conv(*r(32), ch(1024), 2 * hid)
    heads = max(1, hid // 64)
    head_dim = hid // heads
    kd = int(head_dim * 0.5)
    n = (h // 32) * (w // 32)
    for _ in range(d):
        c.conv(*r(32), hid, hid + 2 * kd * heads)
        c.macs += heads * n * n * kd + heads * head_dim * n * n
        c.conv(*r(32), hid, hid, 3, groups=hid)
        c.conv(*r(32), hid, hid)
        c.conv(*r(32), hid, 2 * hid)
        c.conv(*r(32), 2 * hid, hid)
    c.conv(*r(32), 2 * hid, ch(1024))
    # PAN neck
    _c3k2(c, *r(16), ch(1024) + ch(512), ch(512), d, big)
    _c3k2(c, *r(8), ch(512) + ch(512), ch(256), d, big)
    c.conv(*r(16), ch(256), ch(256), 3)
    _c3k2(c, *r(16), ch(256) + ch(512), ch(512), d, big)
    c.conv(*r(32), ch(512), ch(512), 3)
    _c3k2(c, *r(32), ch(512) + ch(1024), ch(1024), d, True)
    # head, per level
    chans = (ch(256), ch(512), ch(1024))
    c2 = max(16, chans[0] // 4, 64)
    c3 = max(chans[0], min(num_classes, 100))
    nk = num_keypoints * 3
    c4 = max(chans[0] // 4, nk)
    for f, s in zip(chans, (8, 16, 32)):
        hh, ww = r(s)
        c.conv(hh, ww, f, c2, 3)
        c.conv(hh, ww, c2, c2, 3)
        c.conv(hh, ww, c2, 64)
        c.conv(hh, ww, f, f, 3, groups=f)
        c.conv(hh, ww, f, c3)
        c.conv(hh, ww, c3, c3, 3, groups=c3)
        c.conv(hh, ww, c3, c3)
        c.conv(hh, ww, c3, num_classes)
        c.conv(hh, ww, f, c4, 3)
        c.conv(hh, ww, c4, c4, 3)
        c.conv(hh, ww, c4, nk)
    return 2.0 * c.macs


def rrdb_flops(h: int, w: int, scale: int = 2, feat: int = 64, grow: int = 32, blocks: int = 23) -> float:
    """FLOPs of RRDBNet on an ``h`` x ``w`` input (output ``scale`` times
    larger; the x2 net runs its body at half the input's size)."""
    f = {2: 2, 1: 4}.get(scale, 1)
    c = _Count()
    bh, bw = h // f, w // f
    c.conv(bh, bw, 3 * f * f, feat, 3)
    for _ in range(3 * blocks):
        for i in range(4):
            c.conv(bh, bw, feat + i * grow, grow, 3)
        c.conv(bh, bw, feat + 4 * grow, feat, 3)
    c.conv(bh, bw, feat, feat, 3)
    c.conv(2 * bh, 2 * bw, feat, feat, 3)
    c.conv(4 * bh, 4 * bw, feat, feat, 3)
    c.conv(4 * bh, 4 * bw, feat, feat, 3)
    c.conv(4 * bh, 4 * bw, feat, 3, 3)
    return 2.0 * c.macs
