"""Carry flax variables (``.npz`` checkpoints of the JAX package) into the
port's modules.

``load_params_npz`` reads the flat ``params/...`` / ``batch_stats/...`` npz
with numpy (float16 storage widened to float32, as
facedet_tpu/engine/detector.load_params_npz does). ``from_jax_variables``
maps the nested tree onto a state dict: the torch modules carry the flax
names, so ``params/backbone/stem/conv/kernel`` becomes
``backbone.stem.conv.weight``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_params_npz", "from_jax_variables", "load_jax_variables"]

# flax leaf name -> torch parameter/buffer name
_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def load_params_npz(path: str) -> dict:
    """Flat 'a/b/c' npz -> nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = flat[key]
            node[parts[-1]] = arr.astype(np.float32) if arr.dtype == np.float16 else arr
    return tree


def _walk(node, prefix=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, prefix + (k,))
    else:
        yield prefix, node


def from_jax_variables(tree: dict) -> dict[str, torch.Tensor]:
    """Nested flax variables {params, batch_stats} -> torch state dict.

    Conv kernels HWIO become OIHW (``transpose(3, 2, 0, 1)``, grouped convs
    included). Quantised (int8) params are not ported yet."""
    state: dict[str, torch.Tensor] = {}
    for path, arr in _walk(tree):
        collection, leaf = path[0], path[-1]
        name = _LEAVES.get((collection, leaf))
        if name is None:
            if leaf in ("qkernel", "ascale", "oscale", "obias"):
                raise NotImplementedError("int8 (quantised) checkpoints are not yet ported")
            raise KeyError(f"unexpected flax variable {'/'.join(path)}")
        arr = np.asarray(arr, np.float32)
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
        state[".".join(path[1:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def load_jax_variables(module: nn.Module, tree: dict) -> None:
    """Load flax variables into ``module``; raises on a missing or extra key
    or a shape mismatch. BatchNorm step counters, which flax does not keep,
    are set to 0."""
    state = from_jax_variables(tree)
    own = module.state_dict()
    counters = {k for k in own if k.endswith("num_batches_tracked")}
    missing = sorted(set(own) - counters - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"flax variables do not match the module: missing {missing[:8]}, extra {extra[:8]}")
    for k in counters:
        state[k] = torch.zeros_like(own[k])
    module.load_state_dict(state, strict=True)
