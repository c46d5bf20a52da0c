"""ConvBnAct's inference epilogue: the CUDA kernel of ``csrc/bn_act.cu`` and
its plain PyTorch version.

``bn_act(x, bn, out_dtype, act)`` is ``activate(bn(x.float()).to(out_dtype),
act)`` for an eval-mode BatchNorm ``bn`` on the conv output ``x`` (bfloat16 or
float32, NCHW- or channels-last-contiguous): the float32 affine from the
running statistics, the cast to ``out_dtype`` and the activation, in one pass
that reads each element once and writes it once. It replaces no Pallas kernel
(the JAX package leaves the chain to XLA); it replaces the four PyTorch and
cuDNN kernels that ran after every conv. A CUDA tensor launches the kernel (or
raises). A gradient recorded through it takes the closed-form backward of
the chain (``_BnAct``): the kernel has no backward of its own, and the
perceptual loss of train/perceptual.py differentiates a frozen eval-mode
backbone. The plain version, which is that chain itself, runs for a tensor off
the card, and the modules call it in train mode. A trace (``torch.jit.trace``, the ONNX
export) cannot see inside the kernel: it is refused on the card, and a model is
traced on the CPU, where the chain runs. There is no fallback from one to the
other.

Counters: a call adds 1 to ``epilogue_kernel`` (the kernel ran) or
``epilogue_plain`` (the plain version ran) of the span open on its thread
(``utils.profiling.SPANS.add``): the detector's ``detector`` span counts the
epilogues of its forward that way.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from facedet_tpu_torch.utils.profiling import SPANS

__all__ = ["LAUNCHES", "activate", "bn_act", "bn_act_ref"]

# Launch count: a run reads it to show it went through the kernel. Only the
# CUDA branch of the wrapper increments it.
LAUNCHES = {"bn_act": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_NUMEL = 1 << 31


def activate(x: torch.Tensor, act) -> torch.Tensor:
    """``ConvBnAct``'s activation: ``True`` SiLU, ``"relu"`` ReLU (the
    HGNetv2 backbone's), ``False`` none."""
    if act == "relu":
        return F.relu(x)
    return F.silu(x) if act else x


def bn_act_ref(x: torch.Tensor, bn: torch.nn.Module, out_dtype: torch.dtype, act) -> torch.Tensor:
    """Plain version: the BatchNorm module in float32 (in its own mode: a
    train-mode ``FlaxBatchNorm2d`` takes flax's batch statistics), the cast to
    ``out_dtype``, the activation."""
    SPANS.add("epilogue_plain")
    return activate(bn(x.float()).to(out_dtype), act)


def _params(x: torch.Tensor, bn: torch.nn.Module) -> tuple:
    c = x.shape[1]
    params = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    for p in params:
        if p is None or p.dtype != torch.float32 or p.device != x.device or tuple(p.shape) != (c,) \
                or not p.is_contiguous():
            raise ValueError(f"the BatchNorm's weight, bias and running statistics must be contiguous float32 "
                             f"[{c}] on {x.device}")
    return params


_SMS: dict[int, int] = {}  # multiprocessors by device index: the grid's size


def _launch(x: torch.Tensor, weight, bias, mean, var, eps: float, out_dtype: torch.dtype, act) -> torch.Tensor:
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"input {x.dtype} and output {out_dtype} must each be one of {tuple(_DTYPES)}")
    if x.is_contiguous():
        channels_last = False
    elif x.is_contiguous(memory_format=torch.channels_last):
        channels_last = True
    else:
        raise ValueError(f"x must be NCHW- or channels-last-contiguous, got strides {x.stride()}")
    if x.numel() >= _MAX_NUMEL:
        raise ValueError(f"{x.numel()} elements exceed the kernel's 32-bit indexing")
    n, c, h, w = x.shape
    y = torch.empty((n, c, h, w), dtype=out_dtype, device=x.device,
                    memory_format=torch.channels_last if channels_last else torch.contiguous_format)
    sms = _SMS.get(x.device.index)
    if sms is None:
        sms = _SMS[x.device.index] = torch.cuda.get_device_properties(x.device).multi_processor_count
    from facedet_tpu_torch.ops.kernels import build

    lib = build.load("bn_act")
    with torch.cuda.device(x.device):
        rc = lib.facedet_bn_act(
            x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), var.data_ptr(),
            eps, x.numel(), c, h * w, int(channels_last), _DTYPES[x.dtype], _DTYPES[out_dtype],
            2 if act == "relu" else 1 if act else 0, sms, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"facedet_bn_act launch failed: cudaError_t {rc}")
    LAUNCHES["bn_act"] += 1
    return y


class _BnAct(torch.autograd.Function):
    """The kernel with the chain's gradient in closed form: with the running
    statistics held, ``t = (x - mean) * inv * weight + bias`` (``inv`` =
    ``rsqrt(var + eps)``), ``y = act(t rounded to out_dtype)``, so the
    activation's backward (in ``out_dtype``, as the chain's) gives ``g``, and
    ``dx = g * weight * inv`` (cast back to ``x``'s dtype), ``dweight =
    sum(g * (x - mean) * inv)``, ``dbias = sum(g)`` over N, H, W. The
    running statistics are buffers, with no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps, out_dtype, act):
        y = _launch(x, weight, bias, mean, var, eps, out_dtype, act)
        ctx.save_for_backward(x, y, weight, bias, mean, var)
        ctx.eps, ctx.out_dtype, ctx.act = eps, out_dtype, act
        return y

    @staticmethod
    def backward(ctx, g):
        x, y, weight, bias, mean, var = ctx.saved_tensors
        if ctx.act == "relu":
            g = torch.ops.aten.threshold_backward(g, y, 0)
        elif ctx.act:
            # SiLU's backward reads its input: the rounded affine, recomputed
            # by the chain's own BatchNorm (the kernel's value, element for
            # element, for NCHW input)
            t = F.batch_norm(x.float(), mean, var, weight, bias, False, 0.0, ctx.eps).to(ctx.out_dtype)
            g = torch.ops.aten.silu_backward(g, t)
        g = g.float()
        inv = torch.rsqrt(var + ctx.eps)
        per_channel = (1, -1, 1, 1)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (g * (weight * inv).view(per_channel)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (g * ((x.float() - mean.view(per_channel)) * inv.view(per_channel))).sum((0, 2, 3))
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 2, 3))
        return dx, dw, db, None, None, None, None, None


def bn_act(x: torch.Tensor, bn: torch.nn.Module, out_dtype: torch.dtype, act) -> torch.Tensor:
    """x [N,C,H,W] bfloat16 or float32 -> ``activate(bn(x.float()).to(out_dtype),
    act)`` [N,C,H,W] in ``out_dtype`` and ``x``'s layout; ``bn`` an eval-mode
    BatchNorm of C channels, ``act`` as ``activate`` takes it."""
    if not x.is_cuda:
        return bn_act_ref(x, bn, out_dtype, act)
    if bn.training:
        raise ValueError("the kernel computes an eval-mode BatchNorm; a train-mode one takes bn_act_ref")
    if torch.jit.is_tracing():
        raise RuntimeError("a trace cannot record the bn_act kernel: trace the model on the CPU, where ConvBnAct "
                           "runs PyTorch ops")
    if x.dim() != 4:
        raise ValueError(f"x must be rank 4 [N,C,H,W], got shape {tuple(x.shape)}")
    weight, bias, mean, var = _params(x, bn)
    eps = float(bn.eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        y = _BnAct.apply(x, weight, bias, mean, var, eps, out_dtype, act)
    else:
        y = _launch(x, weight, bias, mean, var, eps, out_dtype, act)
    SPANS.add("epilogue_kernel")
    return y
