"""Seeded random initialisation shared by the port's detectors."""
from __future__ import annotations

import torch

__all__ = ["random_init"]

_NORMS = (torch.nn.modules.batchnorm._NormBase, torch.nn.GroupNorm, torch.nn.LayerNorm)
_KERNELS = (torch.nn.Conv2d, torch.nn.Linear)


def random_init(model: torch.nn.Module, seed: int) -> None:
    """Random weights from a seeded CPU generator, so that a seed gives the
    same model on the card and on the CPU: conv and linear kernels
    N(0, 1/fan_in), their biases 0, bare parameters (an embedding table)
    N(0, 0.02^2); the norms keep torch's defaults, which are flax's (scale
    1, bias 0, mean 0, var 1). Call it before the model moves to its
    device."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _KERNELS):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * fan_in**-0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif not isinstance(m, _NORMS):
                for p in m.parameters(recurse=False):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
