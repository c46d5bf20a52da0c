"""RT-DETR-l (Ultralytics ``rtdetr-l.yaml``; arXiv:2304.08069): the
program's ``RtDetrDetectionModel`` at the configuration's published variant,
the plain reference's forward (``reference/rtdetr_l.py``) with the wrapper's
post-processing (top-300 by a stable descending sort, the confidence filter,
no NMS), and the FLOPs of the published layout (``rtdetr_flops.py``).

Weights: ``{"seed": N}`` only (the repository holds no RT-DETR checkpoint),
drawn by ``draw`` under Ultralytics' state-dict names. A random RT-DETR-l is
chaotic where a trained one is not: with BatchNorm statistics taken as the
mean and variance of each layer's input and shifts near 0, bfloat16's
rounding grew to 43% of the P5 map (RMS against the float32 reference, on the
CPU at 320x320) and the top-300 selection kept 61% of its tokens. So the draw
keeps the ReLUs mostly open and the transformer's residual branches short:

  * conv kernels He-scaled, N(0, 2 / fan_in); linears N(0, 1 / fan_in),
    biases 0; LayerNorms 1 and 0;
  * BatchNorm scales U(0.4, 0.6) and shifts N(1, 0.2^2); statistics from the
    float32 reference's own forward of a seeded 256x256 photo, layer by layer:
    each BatchNorm's variance is the mean square of its input and its mean 0,
    so that it only scales (a mean taken out of a large common part would
    magnify the rounding behind it), but for ``input_proj``, whose mean is
    taken out, so that the encoder's tokens differ; rounded to 8 significant
    bits, so that a CPU's last bits do not reach the arrays;
  * the kernels that close a residual branch of AIFI and of the decoder
    layers (``out_proj``, ``output_proj``, ``linear2``, ``fc2``) at 0.3;
  * ``sampling_offsets`` as Ultralytics initialises them (bias: each head's
    direction times the point's rank), their kernels at a tenth; the last
    layer of every box MLP at a tenth, so that boxes stay near their anchors;
  * the decoder's score heads at five times the linears' scale, with the bias
    ``SCORE_BIAS``, chosen so that the reference finds about 5 to 20
    detections scoring 0.5 or more in a photo of the ``single_rgb`` mix
    (1024x1536, 12 faces of 50-140 px) and about a hundred scoring 0.3 or
    more before the merge, well under its 1,024 rows.
"""
from __future__ import annotations

import math

import numpy as np

from port_bench import rtdetr_flops, weights

HEADS = 8  # the published decoder's heads
CALIBRATION_PX = 256
SCORE_BIAS = 1.875
SCORE_GAIN = 5.0  # scale of the decoder's score-head kernels
BN_SCALE = (0.4, 0.6)  # uniform
BN_SHIFT = (1.0, 0.2)  # normal: mean, deviation
BRANCH = 0.3  # scale of the kernels that close a transformer layer's residual branch
BRANCHES = ("out_proj.weight", "output_proj.weight", "linear2.weight", "fc2.weight")


def _round(a: np.ndarray) -> np.ndarray:
    """To 8 significant bits, so that the last bits of a CPU's sums do not
    reach the drawn arrays."""
    m, e = np.frexp(a.astype(np.float64))
    return np.ldexp(np.round(m * 256.0) / 256.0, e).astype(np.float32)


def drawn(seed: int, shapes: dict, heads: int = HEADS, score_bias: float = SCORE_BIAS) -> dict:
    """{Ultralytics name: float32 array} of the layout ``shapes``
    (``reference.rtdetr_l.state_shapes``) from ``seed``."""
    import torch

    from port_bench import inputs
    from port_bench.reference import rtdetr_l

    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(shapes):
        shape = shapes[key]
        leaf = key.rsplit(".", 1)[1]
        scope = key.rsplit(".", 1)[0]
        batchnorm = f"{scope}.running_var" in shapes
        if len(shape) == 4:
            a = rng.standard_normal(shape) * math.sqrt(2.0 / np.prod(shape[1:]))
        elif leaf == "running_mean":
            a = np.zeros(shape)
        elif leaf == "running_var":
            a = np.ones(shape)
        elif batchnorm and leaf == "weight":
            a = rng.uniform(*BN_SCALE, shape)
        elif batchnorm and leaf == "bias":
            a = BN_SHIFT[0] + BN_SHIFT[1] * rng.standard_normal(shape)
        elif ".norm" in key or ".enc_output.1." in key:
            a = np.ones(shape) if leaf == "weight" else np.zeros(shape)
        elif leaf in ("weight", "in_proj_weight") and len(shape) == 2:
            scale = 1.0 / math.sqrt(shape[1])
            if key.endswith("sampling_offsets.weight") or (".layers.2." in key and "bbox_head" in key):
                scale *= 0.1
            elif key.endswith(BRANCHES):
                scale *= BRANCH
            elif "dec_score_head" in key:
                scale *= SCORE_GAIN
            a = rng.standard_normal(shape) * scale
        elif key.endswith("sampling_offsets.bias"):
            points = shape[0] // (heads * rtdetr_l.LEVELS * 2)
            theta = np.arange(heads, dtype=np.float64) * (2.0 * math.pi / heads)
            grid = np.stack([np.cos(theta), np.sin(theta)], -1)
            grid = grid / np.abs(grid).max(-1, keepdims=True)
            grid = np.tile(grid[:, None, None, :], (1, rtdetr_l.LEVELS, points, 1))
            grid *= np.arange(1, points + 1, dtype=np.float64)[None, None, :, None]
            a = grid.reshape(-1)
        elif "dec_score_head" in key and leaf == "bias":
            a = np.full(shape, score_bias)
        else:
            a = np.zeros(shape)
        out[key] = np.asarray(a, np.float32)

    # BatchNorm statistics from the reference's forward of a seeded photo
    params = {k: torch.from_numpy(v.copy()) for k, v in out.items()}

    class Calibrating(rtdetr_l.RtDetrL):
        def bn(self, scope, y):
            if ".input_proj." in scope:
                mean = y.mean((0, 2, 3))
                self.p[f"{scope}.running_mean"] = torch.from_numpy(_round(mean.numpy()))
                y2 = (y - mean[:, None, None]).square().mean((0, 2, 3))
            else:
                y2 = y.square().mean((0, 2, 3))
            self.p[f"{scope}.running_var"] = torch.from_numpy(_round(y2.numpy()))
            return super().bn(scope, y)

    photo = inputs.photo(seed, 0, (CALIBRATION_PX, CALIBRATION_PX), 2, (40, 80))
    x = torch.from_numpy(photo).permute(2, 0, 1)[None].float() / 255.0
    net = Calibrating(params, num_heads=heads)
    with torch.inference_mode():
        feats = net.encoder(*net.backbone(x))
        for i, f in enumerate(feats):
            net.bn(f"{rtdetr_l.DECODER}.input_proj.{i}.1", net.conv(f, params[f"{rtdetr_l.DECODER}.input_proj.{i}.0.weight"]))
    for key in out:
        if key.endswith(("running_mean", "running_var")):
            out[key] = params[key].numpy()
    return out


def draw(seed: int) -> dict:
    """The published layout with one face class, drawn from ``seed``."""
    from port_bench.reference import rtdetr_l

    return drawn(seed, rtdetr_l.state_shapes(num_classes=1))


def _weights(det: dict):
    if not weights.seeded(det["weights"]):
        raise ValueError("the rtdetr family draws its weights from a seed; the repository holds no checkpoint")
    return det["weights"]


def program(config: dict, device, int8: bool = False):
    """The configuration's detector on ``device``; ``int8`` switches on the
    program's own int8 path over the conv stack (``models.quantize.
    quantize_detector``: the backbone and the neck; the stem and the
    decoder's input projections kept), the check's control."""
    from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel

    from port_bench.harness import ROOT

    d = config["detector"]
    model = RtDetrDetectionModel(model_path=weights.path(_weights(d), ROOT, draw), variant=d["variant"],
                                 image_size=d["image_size"], dtype=d["dtype"], device=device,
                                 confidence_threshold=d["confidence_threshold"],
                                 category_mapping={str(i): "face" for i in range(d["num_classes"])})
    if int8:
        from facedet_tpu_torch.models.quantize import quantize_detector

        quantize_detector(model)
    return model


def reference(config: dict, root: str, device):
    """``(tiles [B, 3, h, w] float32, conf)`` -> per tile numpy {boxes,
    scores, kpts} in tile pixels."""
    from port_bench.reference import rtdetr_l

    net = rtdetr_l.RtDetrL(weights.tensors(weights.arrays(_weights(config["detector"]), root, draw), device),
                           num_heads=config.get("num_heads", HEADS), num_queries=config.get("num_queries", 300))
    return lambda tiles, conf: rtdetr_l.tile_detections(net, tiles, conf)


def flops(h: int, w: int, det: dict) -> float:
    return rtdetr_flops.rtdetr_l_flops(h, w, det["num_classes"])
