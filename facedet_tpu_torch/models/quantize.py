"""Post-training int8 quantization of the ``ConvBnAct`` stack.

Counterpart of facedet_tpu/models/quantize.py, with its numbers: weights
symmetric per output channel (absmax over I*H*W / 127), activations per
tensor from calibration (absmax / 127), the BatchNorm folded into ``oscale``
/ ``obias``. The same scopes are chosen by the same rules: not excluded
(``DEFAULT_EXCLUDE``: the head, and the early stack stem / down1 / c3k2_0),
not depthwise (one input channel per group), calibrated with a positive
absmax, and not vetoed by ``predicate``. Scopes are flax paths, tuples of
module names such as ``("backbone", "down2")``, the keys of the JAX
package's ``calibrate``, so one absmax dict or exclusion list means the same
in both packages. A model that names its own exclusions (``INT8_EXCLUDE``:
the published RT-DETR-l's stem) is quantized with them by
``quantize_detector``; a conv whose padding is not ``k // 2`` is never
chosen (the int8 conv pads so).

Where the JAX package swaps the variables tree, the port swaps modules:
each chosen ``ConvBnAct`` is replaced in its parent by an ``Int8ConvBnAct``
(models/layers.py) on the same device. The scales are computed in numpy
float32 on the host with the reference's expressions, so given one absmax
dict both packages hold the same bits. They are computed from float32
kernels, as the reference quantizes its float32 params: a bfloat16 model
(whose ``set_dtypes`` rounded its conv weights) is quantized from a float32
twin (``float_model``), which the detector rebuilds from its checkpoint.
Calibration runs on the model's own device and in its compute dtype (the
JAX package always calibrates on the CPU): scales from the card and from
the CPU differ in their last bits, so a comparison of the two quantizes once
and carries the buffers across (``from_jax``).
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from facedet_tpu_torch.models.layers import ConvBnAct, Int8ConvBnAct

__all__ = [
    "CALIBRATING",
    "DEFAULT_EXCLUDE",
    "BN_EPS",
    "calibrate",
    "quantize_layer",
    "quantize_model",
    "quantize_detector",
    "int8_shells",
]

# True while calibrate() runs, as in the JAX package
CALIBRATING = False

DEFAULT_EXCLUDE = (
    ("head",),
    ("backbone", "stem"),
    ("backbone", "down1"),
    ("backbone", "c3k2_0"),
)

BN_EPS = 1e-3  # ConvBnAct's BatchNorm epsilon


def _excluded(path: tuple, exclude: Iterable[tuple]) -> bool:
    return any(path[: len(e)] == tuple(e) for e in exclude)


def _path(name: str) -> tuple:
    return tuple(name.split(".")) if name else ()


def calibrate(model: nn.Module, batches) -> dict:
    """Run ``batches`` ([B,H,W,3] in [0,1], numpy or tensors) through
    ``model`` (its NHWC ``forward``) on its device; returns {path: absmax}
    of every ``ConvBnAct`` input (``abs`` in float32, the max over all
    batches), recorded by a forward pre-hook on each."""
    global CALIBRATING
    absmax = {}

    def record(path):
        def hook(_module, args):
            amax = args[0].float().abs().amax()
            absmax[path] = amax if path not in absmax else torch.maximum(absmax[path], amax)

        return hook

    hooks = [m.register_forward_pre_hook(record(_path(name)))
             for name, m in model.named_modules() if isinstance(m, ConvBnAct)]
    device = next(model.parameters()).device
    CALIBRATING = True
    try:
        with torch.inference_mode():
            for x in batches:
                model(torch.as_tensor(np.asarray(x, np.float32)).to(device))
        return {path: float(v) for path, v in absmax.items()}
    finally:
        CALIBRATING = False
        for h in hooks:
            h.remove()


def _quantizable(m, path: tuple, act_absmax: dict, exclude, predicate) -> bool:
    kernel = m.conv.weight
    return (
        not _excluded(path, exclude)
        and kernel.shape[1] > 1  # skip depthwise
        and m.conv.padding[0] == kernel.shape[-1] // 2  # int8_conv pads k // 2
        and path in act_absmax
        and act_absmax[path] > 0
        and (predicate is None or predicate(path, kernel))
    )


def _int8_like(m):
    """An ``Int8ConvBnAct`` of the shape of the ``ConvBnAct`` ``m``, on its
    device, its buffers still to be set."""
    conv = m.conv
    shell = Int8ConvBnAct(conv.in_channels, conv.out_channels, conv.kernel_size[0], conv.stride[0], conv.groups, m.act)
    shell.bn_dtype = m.bn_dtype
    return shell.to(conv.weight.device)


def quantize_layer(m, absmax: float, kernel: Optional[torch.Tensor] = None):
    """A ``ConvBnAct`` and its input's absmax -> its ``Int8ConvBnAct``, on
    the same device, with the reference's numbers (numpy float32, the kernel
    in HWIO as the reference holds it). ``kernel`` is the float32 OIHW
    weight to quantize, ``m``'s own when None (which must then be float32)."""
    if kernel is None:
        kernel = m.conv.weight
    if kernel.dtype != torch.float32:
        raise ValueError(f"quantizing a {kernel.dtype} kernel: the reference quantizes float32 weights "
                         "(pass the float32 twin as float_model)")
    bn = m.bn
    kernel = kernel.detach().cpu().numpy().transpose(2, 3, 1, 0)
    wmax = np.maximum(np.abs(kernel).max(axis=(0, 1, 2)), 1e-12)
    wscale = wmax / 127.0
    qkernel = np.clip(np.round(kernel / wscale), -127, 127).astype(np.int8)
    ascale = np.float32(absmax / 127.0)
    var = bn.running_var.detach().float().cpu().numpy()
    mean = bn.running_mean.detach().float().cpu().numpy()
    g = bn.weight.detach().float().cpu().numpy() / np.sqrt(var + BN_EPS)
    b = bn.bias.detach().float().cpu().numpy() - mean * g
    out = _int8_like(m)
    out.load_state_dict({
        "qkernel": torch.from_numpy(np.ascontiguousarray(qkernel.transpose(3, 2, 0, 1))),
        "ascale": torch.tensor(ascale),
        "oscale": torch.from_numpy((ascale * wscale * g).astype(np.float32)),
        "obias": torch.from_numpy(b.astype(np.float32)),
    })
    return out


def _replace(model: nn.Module, path: tuple, new: nn.Module) -> None:
    setattr(model.get_submodule(".".join(path[:-1])), path[-1], new)


def quantize_model(
    model: nn.Module,
    act_absmax: dict,
    exclude: Iterable[tuple] = DEFAULT_EXCLUDE,
    predicate: Optional[Callable[[tuple, torch.Tensor], bool]] = None,
    float_model: Optional[nn.Module] = None,
) -> int:
    """Swap every chosen ``ConvBnAct`` of ``model`` for its int8 form in
    place; returns the count. ``predicate(path, kernel)`` (the float OIHW
    weight) can veto a scope. ``float_model`` is ``model``'s float32 twin
    (the same modules before ``set_dtypes``), whose kernels are quantized
    where ``model``'s are bfloat16; each must round to ``model``'s. Raises
    ``ValueError`` when nothing is quantized, or a kernel is not float32
    and not its twin's rounding."""
    chosen = [
        (_path(name), m)
        for name, m in model.named_modules()
        if isinstance(m, ConvBnAct) and _quantizable(m, _path(name), act_absmax, exclude, predicate)
    ]
    if not chosen:
        raise ValueError("no ConvBnAct scope was quantized — check calibration paths")
    kernels = {path: m.conv.weight for path, m in chosen}
    if float_model is not None:
        for path, m in chosen:
            twin = float_model.get_submodule(".".join(path)).conv.weight.detach().float().cpu()
            if not torch.equal(twin.to(m.conv.weight.dtype), m.conv.weight.detach().cpu()):
                raise ValueError(f"float_model's kernel at {path} is not the model's: they hold other weights")
            kernels[path] = twin
    for path, m in chosen:
        _replace(model, path, quantize_layer(m, act_absmax[path], kernels[path]))
    return len(chosen)


def int8_shells(model: nn.Module, paths: Iterable[tuple]) -> None:
    """Replace the ``ConvBnAct`` at each path by an ``Int8ConvBnAct`` of
    its shape, for a quantized state to be loaded into."""
    for path in paths:
        m = model.get_submodule(".".join(path))
        if not isinstance(m, Int8ConvBnAct):
            _replace(model, path, _int8_like(m))


def _iter_q(model: nn.Module):
    """The paths of the quantized scopes of ``model``."""
    for name, m in model.named_modules():
        if isinstance(m, Int8ConvBnAct):
            yield _path(name)


def quantize_detector(det, calib_images=None, n_calib: int = 4) -> int:
    """Quantize a loaded detector in place: calibrate on ``calib_images``
    (uint8 HWC list; synthetic natural-statistics tiles when None) on the
    detector's device, in its dtype, and swap the chosen layers of
    ``det.model``, quantizing float32 kernels (a bfloat16 detector's from
    ``det.float32_model()``), outside the model's ``INT8_EXCLUDE`` scopes
    where it names them, else ``DEFAULT_EXCLUDE``'s. The detector's CUDA
    graphs, which hold the replaced layers' weights, are dropped. Returns
    the quantized-conv count."""
    if getattr(det, "model", None) is None:
        det.load_model()
    size = int(getattr(det, "image_size", None) or 640)
    if calib_images is None:
        calib_images = [_natural_tile(size, seed=i) for i in range(n_calib)]
    batches = []
    for im in calib_images:
        x = np.asarray(im, np.float32) / 255.0
        if x.shape[0] != size or x.shape[1] != size:
            y = np.zeros((size, size, 3), np.float32)
            y[: min(size, x.shape[0]), : min(size, x.shape[1])] = x[:size, :size]
            x = y
        batches.append(x[None])
    float_model = None
    if any(p.dtype != torch.float32 for p in det.model.parameters()):
        float_model = det.float32_model()
    quantize_model(det.model, calibrate(det.model, batches),
                   exclude=getattr(det.model, "INT8_EXCLUDE", DEFAULT_EXCLUDE), float_model=float_model)
    det.forward_graphs.clear()
    return sum(1 for _ in _iter_q(det.model))


def _natural_tile(size: int, seed: int = 0) -> np.ndarray:
    """Multi-scale smooth-noise tile (the bench generator's texture) — a
    stand-in calibration input with natural image statistics."""
    rng = np.random.default_rng(seed)
    base = np.zeros((size, size, 3), np.float32)
    for octave in (8, 32, 128):
        up = np.kron(
            rng.standard_normal((octave, octave, 3)).astype(np.float32),
            np.ones((size // octave, size // octave, 1), np.float32),
        )
        base += up * (1.0 / octave) ** 0.35
    base -= base.min()
    base *= 255.0 / max(base.max(), 1e-6)
    return base.astype(np.uint8)
