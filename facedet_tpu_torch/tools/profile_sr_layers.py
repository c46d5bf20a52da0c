"""Per-layer RRDB profile at the SR serving shape, on the card.

Counterpart of facedet_tpu/tools/profile_sr_layers.py, in bfloat16 at
512x768 (the body's resolution of a x4 image), channels-last activations
and weights as ``FaceEnhancer`` keeps them on the card (NCHW would add
cuDNN's layout transposes to every conv):

  conv shapes   every distinct conv of the RRDB body at its true resolution,
                with 128- and 256-out reference convs; the up-path convs at
                2x and 4x
  rdb forms     one ResidualDenseBlock as written (the port's own module:
                concat then conv), ``rdb_sum`` (the same function as a sum of
                convs on slices of each weight: conv(concat(a, b), W) =
                conv(a, Wa) + conv(b, Wb), no concatenation) and the
                elementwise-only baseline
  full blocks   one RRDB (3 RDBs and the scaled residual), and the 69 RDBs of
                the 23-block body extrapolated from one

Each row gives wall ms, device ms and launches per call
(``utils.profiling.device_time``) and, for the convs and blocks, TFLOP/s
from the device ms and its share of the H100's dense bfloat16 peak
(``BF16_PEAK``). The rows measure the concatenations' share of SR's device
time (ROADMAP.md §2).

Run on the card: python -m facedet_tpu_torch.tools.profile_sr_layers
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from facedet_tpu_torch.models.rrdbnet import LRELU_SLOPE

BF16_PEAK = 989e12  # FLOP/s, H100 SXM dense bfloat16, NVIDIA data sheet (at 700 W)
GROW, FEAT = 32, 64
CL = torch.channels_last  # the layout FaceEnhancer serves in on the card


def _act(x):
    return F.leaky_relu(x, LRELU_SLOPE)


def rdb_sum(block, x: torch.Tensor) -> torch.Tensor:
    """The port's ``ResidualDenseBlock`` (``block``) on NCHW ``x`` as a sum
    of convs on input-channel slices of each weight, in place of the
    concatenations: the same function, summed in another order. Each conv's
    bias is added once."""
    feats = [x]
    for i in range(1, 6):
        conv = getattr(block, f"conv{i}")
        lo, y = 0, None
        for f in feats:
            w = conv.weight[:, lo : lo + f.shape[1]]
            term = F.conv2d(f, w, conv.bias if lo == 0 else None, padding=1)
            y = term if y is None else y + term
            lo += f.shape[1]
        if i == 5:
            return x + 0.2 * y
        feats.append(_act(y))


def elementwise(x: torch.Tensor) -> torch.Tensor:
    """The elementwise-only baseline: one leaky ReLU pass over the block's
    input (``leaky_relu(x * 0.2 + 0.1)``), a floor for a block's memory
    traffic."""
    return _act(x * 0.2 + 0.1)


def conv_flops(h: int, w: int, cin: int, cout: int) -> float:
    return 2.0 * 9 * h * w * cin * cout


def rdb_flops(h: int, w: int) -> float:
    """The five convs of one ResidualDenseBlock at ``h`` x ``w``."""
    return sum(conv_flops(h, w, FEAT + i * GROW, GROW) for i in range(4)) + conv_flops(h, w, FEAT + 4 * GROW, FEAT)


def main(h: int = 512, w: int = 768, device: str = "cuda", iters: int = 5, profile_iters: int = 2) -> dict:
    """Every row at ``h`` x ``w``, bfloat16, seeded random weights (N(0,
    0.02)) and inputs, channels-last. Returns ``{"rows": {label: row}, "body_69_rdb_ms":
    device ms of 69 RDBs (wall ms on the CPU)}``; a row has ``tflops`` and
    ``peak_share`` where it computes convs (None on the CPU)."""
    from facedet_tpu_torch.engine.detector import resolve_device
    from facedet_tpu_torch.models.rrdbnet import RRDB, ResidualDenseBlock
    from facedet_tpu_torch.utils.profiling import device_time, format_row

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def mk(*shape, std=1.0):  # activations and conv weights alike
        return (torch.randn(shape, generator=gen) * std).to(dev, bf).contiguous(memory_format=CL)

    rows = {}

    def timed(label, fn, args, flops=None):
        # a window that says the card beat its peak lost records: taken again
        least = flops / BF16_PEAK * 1e3 if flops else None
        row = device_time(fn, *args, iters=iters, profile_iters=profile_iters, min_device_ms=least)
        on_card = row["device_ms"] is not None
        row["tflops"] = flops / row["device_ms"] / 1e9 if flops and on_card else None
        row["peak_share"] = row["tflops"] * 1e12 / BF16_PEAK if row["tflops"] is not None else None
        rows[label] = row
        rate = f"  {row['tflops']:7.1f} TFLOP/s  {100 * row['peak_share']:5.1f}% of peak" if row["tflops"] else ""
        print(format_row(label, row) + rate, flush=True)

    conv = lambda x, wt: F.conv2d(x, wt, padding=1)  # noqa: E731
    print(f"== single convs at {h}x{w} (body resolution) ==", flush=True)
    for cin, cout, tag in [
        (64, 32, "rdb conv1"), (96, 32, "rdb conv2"), (128, 32, "rdb conv3"),
        (160, 32, "rdb conv4"), (192, 64, "rdb conv5"),
        (64, 64, "conv_body"),
        (64, 128, "ref 64->128"), (192, 128, "ref 192->128"),
        (64, 256, "ref 64->256"),
    ]:
        timed(f"{tag} {cin}->{cout}", conv, (mk(1, cin, h, w), mk(cout, cin, 3, 3, std=0.02)),
              conv_flops(h, w, cin, cout))
    print("== up-path convs ==", flush=True)
    for f, cin, cout, tag in [(2, 64, 64, "conv_up1@2x"), (4, 64, 64, "conv_up2@4x"),
                              (4, 64, 64, "conv_hr@4x"), (4, 64, 3, "conv_last@4x")]:
        timed(tag, conv, (mk(1, cin, h * f, w * f), mk(cout, cin, 3, 3, std=0.02)),
              conv_flops(h * f, w * f, cin, cout))

    print("== RDB formulations (one ResidualDenseBlock) ==", flush=True)
    block = ResidualDenseBlock(FEAT, GROW)
    rrdb = RRDB(FEAT, GROW)
    with torch.no_grad():
        for p in list(block.parameters()) + list(rrdb.parameters()):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    block, rrdb = (m.to(dev, bf).to(memory_format=CL).eval() for m in (block, rrdb))
    x0 = mk(1, FEAT, h, w)
    with torch.inference_mode():
        timed("rdb_concat", block, (x0,), rdb_flops(h, w))
        timed("rdb_sum", lambda x: rdb_sum(block, x), (x0,), rdb_flops(h, w))
        timed("elementwise", elementwise, (x0,))
        timed("rrdb (3 RDBs)", rrdb, (x0,), 3 * rdb_flops(h, w))
    key = "wall_ms" if rows["rdb_concat"]["device_ms"] is None else "device_ms"
    body = 69 * rows["rdb_concat"][key]
    print(f"body extrapolation: 69 x rdb_concat = {body:.1f} ms ({key.replace('_', ' ')})")
    return {"rows": rows, "body_69_rdb_ms": body}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card; cpu runs without one)")
    main(device=ap.parse_args().device)
