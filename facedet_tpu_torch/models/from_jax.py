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

``to_jax_variables`` goes the other way for the trainers' ``.npz`` export:
a state dict becomes the nested flax tree (conv ``OIHW`` -> ``HWIO``,
``Linear`` ``[out, in]`` -> ``[in, out]``, ``running_*`` -> ``mean``/``var``,
``weight`` -> ``kernel``/``scale``, bare parameters by name), which
engine/detector.save_params_npz writes flat. The attention projections get
their head axes back from a head map (``attention_heads(model)``: RT-DETR's
``MultiHeadAttention``, TOPIQ's packed ``in_proj_*`` too); without it they
raise.

An int8 tree of the JAX package's ``quantize_variables`` holds, at each
quantized ``ConvBnAct`` scope, ``qkernel`` (int8 HWIO, carried as int8
OIHW), ``ascale``, ``oscale`` and ``obias`` (float32, by name) and no
``batch_stats``; ``load_jax_variables`` first swaps the module at each such
scope for an ``Int8ConvBnAct`` (models/quantize.int8_shells), and
``to_jax_variables`` gives the same leaves back, so a ``save_params_npz`` of
an int8 detector loads in the JAX package.

``load_discriminator_variables`` carries the flax ``PatchDiscriminator``
(facedet_tpu/train/sr_gan.py): its ``params`` as above and its spectral-norm
statistics, kept by flax under ``batch_stats/SpectralNorm_<i>`` with keys
that hold slashes (``c0/kernel/u`` [1, out], ``c0/kernel/sigma`` ()), into
the ``u`` / ``sigma`` buffers of each ``SpectralNormConv2d``.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

__all__ = [
    "load_params_npz",
    "from_jax_variables",
    "to_jax_variables",
    "attention_heads",
    "load_jax_variables",
    "load_discriminator_variables",
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
# the leaves of an int8 ConvBnAct scope (models/quantize.py), kept by name
_INT8_LEAVES = ("qkernel", "ascale", "oscale", "obias")


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
    side, the others ``[D, H, dh]`` on the output side). The int8 leaves
    keep their names, ``qkernel`` its int8 type (HWIO -> OIHW)."""
    state: dict[str, torch.Tensor] = {}
    for path, arr in _walk(tree):
        collection, leaf = path[0], path[-1]
        if collection == "params" and leaf in _INT8_LEAVES:
            arr = np.asarray(arr, np.int8 if leaf == "qkernel" else np.float32)
            if leaf == "qkernel":
                arr = arr.transpose(3, 2, 0, 1)
            state[".".join(path[1:])] = torch.from_numpy(np.array(arr, order="C"))  # 0-d ascale stays 0-d
            continue
        arr = np.asarray(arr, np.float32)
        if collection == "params" and len(path) == 2 and _BARE_PARAMS.fullmatch(leaf):
            state[leaf] = torch.from_numpy(np.ascontiguousarray(arr))
            continue
        name = _LEAVES.get((collection, leaf))
        if name is None:
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


def attention_heads(module: nn.Module) -> dict[str, int]:
    """{module path: head count} of the attention layers in ``module`` (the
    head map ``to_jax_variables`` needs to restore flax's head axes)."""
    from facedet_tpu_torch.models.rtdetr import MultiHeadAttention
    from facedet_tpu_torch.models.topiq import MultiheadAttention

    kinds = (MultiHeadAttention, MultiheadAttention)
    return {name: m.num_heads for name, m in module.named_modules() if isinstance(m, kinds)}


def _unpack_in_proj(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The inverse of ``_pack_in_proj``: ``<p>.in_proj_{weight,bias}`` ->
    ``<p>.{query,key,value}.*`` and ``<p>.out_proj.*`` -> ``<p>.out.*``."""
    out = {}
    for key, value in state.items():
        m = re.fullmatch(r"(.*)\.(in_proj_|out_proj\.)(weight|bias)", key)
        if m is None:
            out[key] = value
        elif m[2] == "out_proj.":
            out[f"{m[1]}.out.{m[3]}"] = value
        else:
            for name, part in zip(("query", "key", "value"), value.chunk(3)):
                out[f"{m[1]}.{name}.{m[3]}"] = part
    return out


def _attention_leaf(kind: str, leaf: str, arr: np.ndarray, heads: int) -> tuple[str, np.ndarray]:
    """A folded ``Linear`` leaf -> flax's: ``query|key|value`` kernels
    ``[D, H, dh]`` and biases ``[H, dh]``, the ``out`` kernel ``[H, dh, D]``."""
    if leaf == "weight":
        arr = arr.T
        return "kernel", arr.reshape(heads, -1, arr.shape[1]) if kind == "out" else arr.reshape(arr.shape[0], heads, -1)
    return "bias", arr if kind == "out" else arr.reshape(heads, -1)


def to_jax_variables(state: dict[str, torch.Tensor], heads: dict[str, int] | None = None) -> dict:
    """Torch state dict -> nested flax variables {params, batch_stats} of
    numpy float32 arrays, the inverse of ``from_jax_variables``. ``heads``
    ({attention module path: head count}, ``attention_heads(model)``) names
    the attention layers. BatchNorm step counters are dropped (flax keeps
    none); a leaf it cannot invert raises ``NotImplementedError``."""
    heads = heads or {}
    tree: dict = {}
    for key, value in _unpack_in_proj(state).items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        if leaf in _INT8_LEAVES:
            node = tree.setdefault("params", {})
            for m in mods:
                node = node.setdefault(m, {})
            arr = value.detach().cpu().numpy()
            node[leaf] = np.array(arr.transpose(2, 3, 1, 0) if leaf == "qkernel" else arr, order="C")
            continue
        arr = value.detach().to("cpu", torch.float32).numpy()
        parent = ".".join(mods[:-1])
        if not mods:
            if not _BARE_PARAMS.fullmatch(leaf):
                raise NotImplementedError(f"{key}: no flax leaf for a bare parameter of this name")
            collection, name = "params", leaf
        elif mods[-1] in ("query", "key", "value", "out") and parent in heads:
            collection = "params"
            name, arr = _attention_leaf(mods[-1], leaf, arr, heads[parent])
        elif mods[-1] in ("query", "key", "value", "out") and parent.endswith("attn"):
            raise NotImplementedError(f"{key}: an attention projection needs its head count (heads=)")
        elif leaf == "running_mean":
            collection, name = "batch_stats", "mean"
        elif leaf == "running_var":
            collection, name = "batch_stats", "var"
        elif leaf == "bias":
            collection, name = "params", "bias"
        elif leaf == "weight" and arr.ndim == 1:
            collection, name = "params", "scale"
        elif leaf == "weight" and arr.ndim in (2, 4):
            collection, name = "params", "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        else:
            raise NotImplementedError(f"{key}: no flax leaf for a {arr.ndim}-d {leaf!r}")
        node = tree.setdefault(collection, {})
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def load_jax_variables(module: nn.Module, tree: dict) -> None:
    """Load flax variables into ``module``; raises on a missing or extra key
    or a shape mismatch. BatchNorm step counters, which flax does not keep,
    are set to 0. The scopes of an int8 tree (those with a ``qkernel``)
    become ``Int8ConvBnAct`` modules first."""
    from facedet_tpu_torch.models.quantize import int8_shells

    int8_shells(module, [p[1:-1] for p, _ in _walk(tree) if p[0] == "params" and p[-1] == "qkernel"])
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


def load_discriminator_variables(module: nn.Module, tree: dict) -> None:
    """Load a flax ``PatchDiscriminator``'s variables into the port's
    (train/sr_gan.py): ``params`` by name, and each
    ``batch_stats/SpectralNorm_<i>/<conv>/kernel/{u,sigma}`` into
    ``<conv>.u`` / ``<conv>.sigma``; raises on a missing or extra leaf."""
    state = from_jax_variables({"params": tree["params"]})
    for stats in tree.get("batch_stats", {}).values():
        for key, arr in stats.items():
            conv, _kernel, leaf = key.split("/")
            state[f"{conv}.{leaf}"] = torch.from_numpy(np.array(arr, np.float32))
    _load_strict(module, state)
