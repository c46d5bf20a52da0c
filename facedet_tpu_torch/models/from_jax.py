"""Carry flax variables (``.npz`` checkpoints of the JAX package) into the
port's modules.

``load_params_npz`` reads the flat ``params/...`` / ``batch_stats/...`` npz
with numpy (float16 storage widened to float32, as
facedet_tpu/engine/detector.load_params_npz does). ``from_jax_variables``
maps the nested tree onto a state dict: the torch modules carry the flax
names, so ``params/backbone/stem/conv/kernel`` becomes
``backbone.stem.conv.weight``.

RRDB checkpoints (``load_rrdb_npz``) hold only ``kernel`` and ``bias``
leaves. The x2 and x1 nets pixel-unshuffle their input, and the flax net
orders the unshuffled channels ``(fy*f + fx)*C + c`` where
``F.pixel_unshuffle`` orders them ``c*f*f + fy*f + fx``. The port keeps the
flax order in its own unshuffle (models/rrdbnet.pixel_unshuffle_nchw), so
``conv_first``'s input channels are carried across unpermuted, like every
other kernel.

SCRFD and RT-DETR add ``Dense`` kernels ``[in, out]`` (transposed into
``Linear.weight``), LayerNorm / GroupNorm scales, the leaves of flax's
``MultiHeadDotProductAttention`` (``query|key|value/kernel`` ``[D, H, dh]``
with bias ``[H, dh]``, ``out/kernel`` ``[H, dh, D]``), which fold into plain
``Linear`` layers, and a bare parameter (``dn_embed``), which keeps its name.

TOPIQ's CFANet (``load_topiq_variables``) keeps torch's
``nn.MultiheadAttention`` layout, the one the JAX package's
``convert_topiq_torch`` reads: the folded ``query``, ``key`` and ``value``
projections are packed into ``attn.in_proj_weight [3D, D]`` and
``in_proj_bias``, ``out`` becomes ``attn.out_proj``, and the bare
``scale_embed{i}`` parameters keep their names.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

__all__ = [
    "load_params_npz",
    "from_jax_variables",
    "load_jax_variables",
    "load_rrdb_npz",
    "load_topiq_variables",
]

# flax leaf name -> torch parameter/buffer name
_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
# parameters that a flax module owns directly (no submodule, no leaf name)
_BARE_PARAMS = re.compile(r"dn_embed|scale_embed\d+")


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
    included); Dense kernels ``[in, out]`` become ``[out, in]``; attention
    kernels fold their head axes (``out/kernel`` ``[H, dh, D]`` on the input
    side, the others ``[D, H, dh]`` on the output side). Quantised (int8)
    params are not ported yet."""
    state: dict[str, torch.Tensor] = {}
    for path, arr in _walk(tree):
        collection, leaf = path[0], path[-1]
        arr = np.asarray(arr, np.float32)
        if collection == "params" and len(path) == 2 and _BARE_PARAMS.fullmatch(leaf):
            state[leaf] = torch.from_numpy(np.ascontiguousarray(arr))
            continue
        name = _LEAVES.get((collection, leaf))
        if name is None:
            if leaf in ("qkernel", "ascale", "oscale", "obias"):
                raise NotImplementedError("int8 (quantised) checkpoints are not yet ported")
            raise KeyError(f"unexpected flax variable {'/'.join(path)}")
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 3:  # attention projection with a head axis
                is_out = len(path) >= 2 and path[-2] == "out"
                arr = arr.reshape(-1, arr.shape[-1]) if is_out else arr.reshape(arr.shape[0], -1)
                arr = arr.T
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise KeyError(f"flax kernel {'/'.join(path)} has an unexpected rank {arr.ndim}")
        elif leaf == "bias" and arr.ndim == 2:  # attention bias [H, dh]
            arr = arr.reshape(-1)
        state[".".join(path[1:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def load_jax_variables(module: nn.Module, tree: dict) -> None:
    """Load flax variables into ``module``; raises on a missing or extra key
    or a shape mismatch. BatchNorm step counters, which flax does not keep,
    are set to 0."""
    _load_strict(module, from_jax_variables(tree))


def _load_strict(module: nn.Module, state: dict[str, torch.Tensor]) -> None:
    own = module.state_dict()
    counters = {k for k in own if k.endswith("num_batches_tracked")}
    missing = sorted(set(own) - counters - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"flax variables do not match the module: missing {missing[:8]}, extra {extra[:8]}")
    for k in counters:
        state[k] = torch.zeros_like(own[k])
    module.load_state_dict(state, strict=True)


def load_rrdb_npz(module: nn.Module, path: str) -> None:
    """Load an RRDBNet ``.npz`` checkpoint of the JAX package into the
    port's ``RRDBNet``; raises when the tree does not fit the module (another
    depth, width or scale)."""
    tree = load_params_npz(path)
    if set(tree) != {"params"}:
        raise KeyError(f"an RRDB checkpoint holds only 'params', got {sorted(tree)}")
    load_jax_variables(module, tree)


def _pack_in_proj(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``<p>.attn.{query,key,value}.{weight,bias}`` -> ``<p>.attn.in_proj_{weight,bias}``
    (rows in that order) and ``<p>.attn.out.*`` -> ``<p>.attn.out_proj.*``."""
    out = {}
    for key, value in state.items():
        m = re.fullmatch(r"(.*\.attn)\.(query|key|value|out)\.(weight|bias)", key)
        if m is None:
            out[key] = value
        elif m[2] == "out":
            out[f"{m[1]}.out_proj.{m[3]}"] = value
        elif m[2] == "query":
            parts = [state[f"{m[1]}.{p}.{m[3]}"] for p in ("query", "key", "value")]
            out[f"{m[1]}.in_proj_{m[3]}"] = torch.cat(parts)
    return out


def load_topiq_variables(module: nn.Module, tree: dict) -> None:
    """Load the flax variables of the JAX package's ``CFANet`` into the
    port's ``CFANet`` (models/topiq.py); every leaf is used and every
    parameter and buffer is set, or it raises."""
    _load_strict(module, _pack_in_proj(from_jax_variables(tree)))
