"""YOLOv11 building blocks as NCHW ``nn.Module``s.

Counterpart of facedet_tpu/models/layers.py. Submodule names are the flax
names (``cv1``, ``m0``, ``attn.qkv``, ``bn`` ...), so a flax variable path maps
onto a state-dict key mechanically (models/from_jax.py). Flax infers input
channels; here each block is given them.

Parity notes: BatchNorm eps is 1e-3 and, in train mode, flax's statistics
(``FlaxBatchNorm2d``, momentum 0.97); ``padding=k//2`` is symmetric in both
frameworks; max-pool pads with -inf; in ``PSAAttention`` the qkv channels are
split per head as ``[heads, 2*key_dim + head_dim]``, as in the NHWC original.

``Int8ConvBnAct`` is the int8 serving form of ``ConvBnAct`` (the reference's
``ConvBnAct._int8_forward``); models/quantize.py swaps it in, and
models/from_jax.py builds it where a flax tree holds a ``qkernel``.

Hazard under data parallelism: GSPMD takes a sharded step's train-mode
BatchNorm statistics over the global batch. ``sync_batch_statistics_(model,
group)`` makes every ``FlaxBatchNorm2d`` of a model a ``GroupBatchNorm2d``,
which sums its statistics over the ranks of ``group`` (those that hold other
images) with the differentiable ``torch.distributed.nn.functional.all_reduce``:
a plain ``dist.all_reduce`` would cut the gradient through the statistics.
Left per rank, the statistics, the normalised activations and the running
buffers would differ from the single-device step on the global batch. The
sharded train step converts its model; ``FlaxBatchNorm2d`` itself knows
nothing of process groups.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

__all__ = [
    "FlaxBatchNorm2d",
    "GroupBatchNorm2d",
    "sync_batch_statistics_",
    "make_divisible",
    "ConvBnAct",
    "Int8ConvBnAct",
    "int8_matmul",
    "Bottleneck",
    "C3k",
    "C3k2",
    "SPPF",
    "PSAAttention",
    "PSABlock",
    "C2PSA",
    "upsample2x",
]


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's ``nn.BatchNorm`` in train mode.

    Eval mode is ``nn.BatchNorm2d``'s, on the running statistics. In train
    mode the batch statistics are taken in float32 as flax's
    ``_compute_stats`` takes them: the mean and the fast variance
    ``E[x^2] - E[x]^2`` clipped at 0, which is the biased variance. The
    input is normalised with them, and the running statistics move as
    ``running = m * running + (1 - m) * batch`` with flax's momentum ``m``,
    the variance from the biased one too (torch's own update uses the
    unbiased variance and ``1 - m``). The parameter and buffer names are
    ``nn.BatchNorm2d``'s, so state dicts and flax checkpoints load
    unchanged; ``num_batches_tracked`` stays as it is (flax keeps no
    counter, and nothing reads it while a momentum is set)."""

    def __init__(self, num_features: int, eps: float = 1e-5, flax_momentum: float = 0.99):
        super().__init__(num_features, eps=eps, momentum=1.0 - flax_momentum)
        self.flax_momentum = flax_momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x = x.float()
        mean, mean_sq = self._moments(x)
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean, alpha=1 - m)
            self.running_var.mul_(m).add_(var, alpha=1 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return torch.addcmul(self.bias[:, None, None], x - mean[:, None, None], mul[:, None, None])

    def _moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(E[x], E[x^2]) per channel of a float32 NCHW batch."""
        return x.mean(dim=(0, 2, 3)), x.square().mean(dim=(0, 2, 3))


class GroupBatchNorm2d(FlaxBatchNorm2d):
    """``FlaxBatchNorm2d`` whose train-mode statistics are those of the
    images of every rank of ``group`` (ranks hold equal local batches): the
    module docstring's hazard. Made by ``sync_batch_statistics_``, which
    sets ``group``."""

    def _moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        import torch.distributed.nn.functional as dist_nn

        world = dist.get_world_size(self.group)
        count = x.shape[0] * x.shape[2] * x.shape[3] * world
        sums = torch.cat([x.sum(dim=(0, 2, 3)), x.square().sum(dim=(0, 2, 3))])
        sums = dist_nn.all_reduce(sums, group=self.group)
        return (sums / count).chunk(2)


def sync_batch_statistics_(model: nn.Module, group) -> nn.Module:
    """In place: every ``FlaxBatchNorm2d`` of ``model`` becomes a
    ``GroupBatchNorm2d`` over ``group`` (its parameters, buffers and hooks
    stay the same objects). A group of one rank holds the global batch
    itself, and then nothing changes. Returns ``model``."""
    if dist.get_world_size(group) == 1:
        return model
    for m in model.modules():
        if isinstance(m, FlaxBatchNorm2d):
            m.__class__ = GroupBatchNorm2d
            m.group = group
    return model


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm (flax's, momentum 0.97) + SiLU.

    The conv runs in its weight's dtype (flax's ``dtype``). The BatchNorm
    keeps float32 statistics and normalises in float32, as flax does (the
    conv output promotes against the float32 statistics), then casts to
    ``bn_dtype``. ``YoloV11.set_dtypes`` sets both."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(
            cin, cout, kernel, stride=stride, padding=kernel // 2, groups=groups, bias=False
        )
        self.bn = FlaxBatchNorm2d(cout, eps=1e-3, flax_momentum=0.97)
        self.act = act
        self.bn_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x.to(self.conv.weight.dtype))
        x = self.bn(x.float()).to(self.bn_dtype)
        return F.silu(x) if self.act else x


def int8_matmul(a: torch.Tensor, w_nk: torch.Tensor, n: int) -> torch.Tensor:
    """``a`` int8 [M, K] times ``w_nk`` int8 [N', K'] transposed -> int32
    [M, n], summed exactly. ``torch._int_mm`` on CUDA takes more than 16
    rows and K and N that are multiples of 8: ``w_nk`` comes padded with
    zeros to that (``K' >= K``, ``N' >= n``), ``a`` is padded here where it
    falls short, and the padding adds nothing to any sum. A shape it still
    refuses raises; nothing falls back to a float product."""
    m, k = a.shape
    if k != w_nk.shape[1] or m <= 16:
        a = F.pad(a, (0, w_nk.shape[1] - k, 0, max(0, 17 - m)))
    return torch._int_mm(a, w_nk.t())[:m, :n]


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


class Int8ConvBnAct(nn.Module):
    """``ConvBnAct`` with int8 weights: the reference's int8 serving path
    (facedet_tpu/models/layers.py ``_int8_forward``).

    Buffers (the flax leaf names): ``qkernel`` int8 ``[Cout, Cin/groups, k,
    k]`` (OIHW, as every conv weight of the port), ``ascale`` the float32
    activation scale, ``oscale`` / ``obias`` float32 ``[Cout]`` (the scales
    and the folded BatchNorm). The forward is the reference's, step by step:

    1. ``xq = int8(clip(round(float32(x) / ascale), -127, 127))``, a true
       division by ``ascale`` as XLA does it for a runtime parameter;
    2. ``acc = conv(xq, qkernel)`` in int32, exactly: the k x k windows of
       the zero-padded NHWC int8 input are gathered by slicing into ``[B*Ho*Wo,
       k*k*Cin]`` (padding stays 0 whether quantized before or after) and
       multiplied by the kernel flattened to ``[k*k*Cin, Cout]`` in one
       ``torch._int_mm`` per group (``int8_matmul``), on the CPU and the
       card alike;
    3. ``y = bn_dtype(float32(acc) * oscale + obias)``, then SiLU if ``act``.

    The GEMM's weight (``[Cout', k*k*Cin']``, zero-padded to multiples of 8)
    is derived from ``qkernel`` and rebuilt whenever a state dict is
    loaded; it is not saved. The output is NCHW in shape with NHWC memory."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.kernel, self.stride, self.groups, self.act = kernel, stride, groups, act
        self.bn_dtype = torch.float32
        self.register_buffer("qkernel", torch.zeros(cout, cin // groups, kernel, kernel, dtype=torch.int8))
        self.register_buffer("ascale", torch.ones(()))
        self.register_buffer("oscale", torch.ones(cout))
        self.register_buffer("obias", torch.zeros(cout))
        self.register_buffer("gemm_weight", torch.empty(0, dtype=torch.int8), persistent=False)
        self.pack()
        self.register_load_state_dict_post_hook(lambda module, _keys: module.pack())

    def pack(self) -> None:
        """Rebuild ``gemm_weight`` [groups, N', K'] from ``qkernel``: each
        group's rows in (dy, dx, c) order, zero-padded."""
        cout, cin_g, k, _ = self.qkernel.shape
        n_g = cout // self.groups
        w = self.qkernel.reshape(self.groups, n_g, cin_g, k, k).permute(0, 1, 3, 4, 2).reshape(self.groups, n_g, k * k * cin_g)
        self.gemm_weight = F.pad(w, (0, _pad8(k * k * cin_g) - k * k * cin_g, 0, _pad8(n_g) - n_g)).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        k, s, p = self.kernel, self.stride, self.kernel // 2
        ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        # float32 NHWC in one copy, then the reference's quantization
        q = torch.empty((b, h, w, c), dtype=torch.float32, device=x.device).copy_(x.permute(0, 2, 3, 1))
        q = torch.div(q, self.ascale)
        torch.round(q, out=q)
        torch.clamp(q, -127.0, 127.0, out=q)
        xq = q.to(torch.int8)
        if p:
            xq = F.pad(xq, (0, 0, p, p, p, p))
        if k == 1 and s == 1:
            cols = xq.reshape(b * ho * wo, 1, c)
        else:
            span_h, span_w = s * (ho - 1) + 1, s * (wo - 1) + 1
            cols = torch.stack(
                [xq[:, dy : dy + span_h : s, dx : dx + span_w : s] for dy in range(k) for dx in range(k)], dim=3
            ).reshape(b * ho * wo, k * k, c)
        n_g, cin_g = self.qkernel.shape[0] // self.groups, c // self.groups
        accs = [
            int8_matmul(cols[:, :, g * cin_g : (g + 1) * cin_g].reshape(b * ho * wo, k * k * cin_g), self.gemm_weight[g], n_g)
            for g in range(self.groups)
        ]
        acc = accs[0] if self.groups == 1 else torch.cat(accs, dim=1)
        y = (acc * self.oscale + self.obias).to(self.bn_dtype)
        if self.act:
            y = F.silu(y)
        return y.reshape(b, ho, wo, -1).permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """Two convs with an optional residual."""

    def __init__(self, cin: int, features: int, shortcut: bool = True, expansion: float = 0.5, kernels=(3, 3)):
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = ConvBnAct(cin, hidden, kernels[0])
        self.cv2 = ConvBnAct(hidden, features, kernels[1])
        self.residual = shortcut and cin == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.residual else y


class C3k(nn.Module):
    """CSP block with 3 convs and n inner bottlenecks."""

    def __init__(self, cin: int, features: int, n: int = 2, shortcut: bool = True, expansion: float = 0.5, kernel: int = 3):
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = ConvBnAct(cin, hidden, 1)
        self.cv2 = ConvBnAct(cin, hidden, 1)
        self.n = n
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(hidden, hidden, shortcut, 1.0, (kernel, kernel)))
        self.cv3 = ConvBnAct(2 * hidden, features, 1)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class C3k2(nn.Module):
    """YOLOv11's C2f-with-C3k-option block."""

    def __init__(self, cin: int, features: int, n: int = 1, c3k: bool = False, expansion: float = 0.5, shortcut: bool = True):
        super().__init__()
        self.hidden = hidden = int(features * expansion)
        self.cv1 = ConvBnAct(cin, 2 * hidden, 1)
        self.n = n
        for i in range(n):
            block = (
                C3k(hidden, hidden, 2, shortcut)
                if c3k
                else Bottleneck(hidden, hidden, shortcut, 0.5)
            )
            setattr(self, f"m{i}", block)
        self.cv2 = ConvBnAct((2 + n) * hidden, features, 1)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, : self.hidden], y[:, self.hidden :]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained stride-1 max-pools."""

    def __init__(self, cin: int, features: int, pool: int = 5):
        super().__init__()
        hidden = cin // 2
        self.pool = pool
        self.cv1 = ConvBnAct(cin, hidden, 1)
        self.cv2 = ConvBnAct(4 * hidden, features, 1)

    def forward(self, x):
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], self.pool, stride=1, padding=self.pool // 2))
        return self.cv2(torch.cat(outs, dim=1))


class PSAAttention(nn.Module):
    """Position-sensitive attention over the HxW grid."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        nh_kd = self.key_dim * num_heads
        self.qkv = ConvBnAct(dim, dim + 2 * nh_kd, 1, act=False)
        self.pe = ConvBnAct(dim, dim, 3, groups=dim, act=False)
        self.proj = ConvBnAct(dim, dim, 1, act=False)

    def forward(self, x):
        b, _, h, w = x.shape
        n = h * w
        kd = self.key_dim
        qkv = self.qkv(x).reshape(b, self.num_heads, 2 * kd + self.head_dim, n)
        q, k, v = qkv[:, :, :kd], qkv[:, :, kd : 2 * kd], qkv[:, :, 2 * kd :]
        # logits and softmax in float32 (JAX: preferred_element_type=float32)
        attn = torch.matmul(q.float().transpose(-1, -2), k.float())  # [b, heads, n, m]
        attn = torch.softmax(attn * (kd**-0.5), dim=-1).to(x.dtype)
        out = torch.matmul(v.to(x.dtype), attn.transpose(-1, -2))  # [b, heads, hd, n]
        out = out.reshape(b, self.dim, h, w)
        out = out + self.pe(v.reshape(b, self.dim, h, w))
        return self.proj(out)


class PSABlock(nn.Module):
    def __init__(self, features: int, num_heads: int):
        super().__init__()
        self.attn = PSAAttention(features, num_heads)
        self.ffn0 = ConvBnAct(features, features * 2, 1)
        self.ffn1 = ConvBnAct(features * 2, features, 1, act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn1(self.ffn0(x))


class C2PSA(nn.Module):
    """Cross-stage partial block with PSA attention."""

    def __init__(self, cin: int, features: int, n: int = 1, expansion: float = 0.5):
        super().__init__()
        self.hidden = hidden = int(features * expansion)
        self.cv1 = ConvBnAct(cin, 2 * hidden, 1)
        self.n = n
        for i in range(n):
            setattr(self, f"m{i}", PSABlock(hidden, max(1, hidden // 64)))
        self.cv2 = ConvBnAct(2 * hidden, features, 1)

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[:, : self.hidden], y[:, self.hidden :]
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
        return self.cv2(torch.cat([a, b], dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (NCHW), as broadcast + reshape: one
    copy, and it exports to ONNX as Unsqueeze / Expand / Reshape."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)
