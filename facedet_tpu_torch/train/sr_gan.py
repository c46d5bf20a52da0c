"""GAN fine-tune for the RRDBNet enhancer, the Real-ESRGAN adversarial arm:
a spectral-norm PatchGAN discriminator, the non-saturating logistic loss
with the Charbonnier pixel term and an optional perceptual term, and the
joint G / D staged loop with an EMA shadow of G.

Counterpart of facedet_tpu/train/sr_gan.py. ``SpectralNormConv2d`` is
flax's ``nn.SpectralNorm`` around an ``nn.Conv`` (flax 0.12's
``_spectral_normalize``), not torch's ``spectral_norm``, whose ``u``
layout, eps and eval behaviour differ: one power step on the kernel as a
``[k*k*in, out]`` matrix, ``v = l2n(u W^T)``, ``u = l2n(v W)`` with
``l2n(x) = x * rsqrt(sum(x^2) + 1e-12)``; ``u`` and ``v`` carry no
gradient, ``sigma = v W u^T`` does; the kernel is divided by sigma unless
it is 0. The power step runs in both modes; ``u`` [1, out] and ``sigma``
are stored in train mode only. The torch kernel's rows are ordered
``(in, kh, kw)`` where flax's are ``(kh, kw, in)``: that permutes ``v``
only, so ``u`` and ``sigma`` carry across unchanged
(models/from_jax.load_discriminator_variables). Convolutions pad as XLA's
"SAME" does; ``jax.nn.softplus`` is ``logaddexp(x, 0)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from facedet_tpu_torch.models.init import random_init
from facedet_tpu_torch.train.sr_train import _flip_draws, _staged_pair, ema_update_, sr_loss

__all__ = [
    "SpectralNormConv2d",
    "PatchDiscriminator",
    "create_discriminator",
    "make_sr_gan_staged_loop",
]


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """XLA's "SAME" padding of an NCHW input: output ceil(size / stride),
    the smaller half of the padding before."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


class SpectralNormConv2d(nn.Conv2d):
    """A "SAME"-padded conv whose kernel is divided by its largest singular
    value, estimated by one power step per call from the stored ``u``
    (flax's ``SpectralNorm(Conv(...))``, see the module docstring)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride=stride)
        self.register_buffer("u", torch.zeros(1, cout))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self) -> torch.Tensor:
        w = self.weight.reshape(self.out_channels, -1)  # [out, in*k*k]
        with torch.no_grad():
            v = _l2n(self.u @ w)
            u = _l2n(v @ w.T)
        sigma = ((v @ w.T) @ u.T)[0, 0]
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(_same_pad(x, self.kernel_size[0], self.stride[0]), self.normalized_weight(), self.bias,
                        self.stride)


class PatchDiscriminator(nn.Module):
    """Spectral-norm PatchGAN: [B,H,W,3] in [0,1] -> [B,H/8,W/8,1] logits
    (the flax layout). Four spectral-norm convs (3x3 stride 1, then 4x4
    stride 2 at base, 2 base, 4 base channels) with leaky ReLU 0.2, and a
    plain 3x3 ``out`` conv."""

    def __init__(self, base: int = 64):
        super().__init__()
        self.c0 = SpectralNormConv2d(3, base, 3, 1)
        self.c1 = SpectralNormConv2d(base, base, 4, 2)
        self.c2 = SpectralNormConv2d(base, base * 2, 4, 2)
        self.c3 = SpectralNormConv2d(base * 2, base * 4, 4, 2)
        self.out = nn.Conv2d(base * 4, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        for conv in (self.c0, self.c1, self.c2, self.c3):
            x = F.leaky_relu(conv(x), 0.2)
        return self.out(x).permute(0, 2, 3, 1)


def create_discriminator(base: int = 64, seed: int = 0) -> PatchDiscriminator:
    """A seeded ``PatchDiscriminator`` (made on the CPU: the caller moves
    it): kernels from ``models/init.random_init``, each initial ``u`` drawn
    N(0, 1), as flax draws it, from a generator seeded with ``seed``."""
    model = PatchDiscriminator(base)
    random_init(model, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SpectralNormConv2d):
                m.u.copy_(torch.randn(m.u.shape, generator=gen))
    return model


def make_sr_gan_staged_loop(
    g_model,
    d_model: PatchDiscriminator,
    g_tx,
    d_tx,
    steps_per_dispatch: int = 50,
    pixel_weight: float = 1.0,
    adv_weight: float = 0.1,
    ema_decay: float = 0.999,
    flip: bool = True,
    percep_fn=None,
    percep_weight: float = 1.0,
    seed: int = 0,
):
    """Joint G / D training over staged uint8 pairs.

    ``run(g_ema, lr_u8, hr_u8, start=0, flips=None) -> metrics``, the mean
    ``pixel``, ``adv``, ``percep`` and ``d`` losses of the call (device
    scalars). Per step: the G step with D in eval mode and frozen (pixel +
    adversarial ``softplus(-D(fake))`` + ``percep_fn(fake, hr)`` when
    given); the D step on ``hr`` and the detached fake, D in train mode
    twice (real first, then the fake from the ``u`` the real pass left);
    the EMA of G into ``g_ema``. ``start`` and ``flips`` as in
    train/sr_train.make_sr_staged_loop."""
    gen = torch.Generator().manual_seed(seed)

    def run(g_ema, lr_u8, hr_u8, start: int = 0, flips=None):
        n, b = lr_u8.shape[:2]
        flips = _flip_draws(flip, flips, steps_per_dispatch, b, gen, lr_u8.device)
        sums = {k: torch.zeros((), device=lr_u8.device) for k in ("pixel", "adv", "percep", "d")}
        for i in range(steps_per_dispatch):
            g = start + i
            lr, hr = _staged_pair(lr_u8, hr_u8, g % n, None if flips is None else flips[i])

            d_model.eval().requires_grad_(False)
            g_tx.zero_grad()
            fake = g_model(lr)
            pix = sr_loss(fake, hr)
            adv = _softplus(-d_model(fake)).mean()  # non-saturating G loss
            total = pixel_weight * pix + adv_weight * adv
            per = torch.zeros((), device=lr.device)
            if percep_fn is not None:
                per = percep_fn(fake, hr)
                total = total + percep_weight * per
            total.backward()
            g_tx.step()

            d_model.train().requires_grad_(True)
            d_tx.zero_grad()
            real_logits = d_model(hr)
            fake_logits = d_model(fake.detach())
            dl = _softplus(-real_logits).mean() + _softplus(fake_logits).mean()
            dl.backward()
            d_tx.step()

            ema_update_(g_ema, g_model, g, ema_decay)
            for k, v in (("pixel", pix), ("adv", adv), ("percep", per), ("d", dl)):
                sums[k] = sums[k] + v.detach()
        return {k: v / steps_per_dispatch for k, v in sums.items()}

    return run
