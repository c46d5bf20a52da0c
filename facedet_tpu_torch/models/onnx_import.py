"""ONNX -> PyTorch importer: load pretrained detector graphs without
onnxruntime or the ``onnx`` package.

Counterpart of facedet_tpu/models/onnx_import.py, in two layers:

  1. a dependency-free protobuf *wire format* parser for the ONNX schema
     subset that model files use (pure Python and numpy, the same code as in
     the JAX package: the wire format is stable by protobuf's compatibility
     rules), and
  2. a graph executor that binds each node to a torch op, yielding a
     function ``module(params, x)`` that runs where its inputs lie.

Weights become a flat ``params`` dict (one entry per float initializer).
Shape arithmetic (Shape -> Gather -> Unsqueeze -> Concat -> Reshape) stays in
numpy and data in torch tensors, as the JAX executor keeps numpy and ``jnp``
apart: a value is *static* while it is numpy, and ``Reshape`` / ``Slice`` /
``Expand`` targets never become device tensors, so no node waits for the
device.

Parity notes: ``Resize`` follows ``jax.image.resize``: "nearest" takes
``floor((i + 0.5) * in / out)``, "linear" and "cubic" (Keys, a = -0.5)
antialias where they shrink (ops/image.resize_nd), and what
``F.interpolate`` would compute instead is never substituted; ``AveragePool``
divides by the count of real elements; ``MaxPool`` pads with -inf;
``GridSample`` "nearest" rounds half to even; ``TopK`` breaks ties toward the
lower index (a stable sort) and returns int64 indices; ``Slice`` treats an
end of 2**31 or more as open. ``Conv`` with ``auto_pad`` SAME_UPPER or
SAME_LOWER pads like XLA's "SAME" (the odd element at the end), as the JAX
executor does for both.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from facedet_tpu_torch.ops.image import resize_nd

__all__ = ["parse_onnx", "parse_onnx_bytes", "OnnxGraph", "OnnxModule", "import_onnx"]


# ---------------------------------------------------------------------------
# protobuf wire-format decoding (schema-agnostic layer)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def _decode_message(buf: bytes) -> dict[int, list[tuple[int, Any]]]:
    """Decode one protobuf message into {field_number: [(wire_type, raw)]}.

    raw is: int for wire 0 (varint), bytes for wire 2 (length-delimited),
    4/8-byte bytes for wires 5/1. Groups (3/4) are not used by ONNX."""
    fields: dict[int, list[tuple[int, Any]]] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field_no, wire = tag >> 3, tag & 0x7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire} for field {field_no}")
        fields.setdefault(field_no, []).append((wire, val))
    return fields


def _signed(v: int) -> int:
    """Interpret a varint as two's-complement int64 (protobuf int64)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _scalar_int(fields, no, default=0):
    vals = fields.get(no)
    return _signed(vals[-1][1]) if vals else default


def _scalar_bytes(fields, no, default=b""):
    vals = fields.get(no)
    return vals[-1][1] if vals else default


def _repeated_int(fields, no) -> list[int]:
    out: list[int] = []
    for wire, raw in fields.get(no, []):
        if wire == 0:
            out.append(_signed(raw))
        else:  # packed
            pos = 0
            while pos < len(raw):
                v, pos = _read_varint(raw, pos)
                out.append(_signed(v))
    return out


def _repeated_float(fields, no) -> list[float]:
    out: list[float] = []
    for wire, raw in fields.get(no, []):
        if wire == 5:
            out.append(struct.unpack("<f", raw)[0])
        else:  # packed
            out.extend(struct.unpack(f"<{len(raw) // 4}f", raw))
    return out


# ---------------------------------------------------------------------------
# ONNX schema subset (field numbers per onnx.proto3, frozen by protobuf
# compatibility rules)
# ---------------------------------------------------------------------------

_TENSOR_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    f = _decode_message(buf)
    dims = _repeated_int(f, 1)
    dtype_code = _scalar_int(f, 2, 1)
    name = _scalar_bytes(f, 8).decode()
    np_dtype = _TENSOR_DTYPES.get(dtype_code)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {dtype_code}")
    raw = _scalar_bytes(f, 9, None)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif dtype_code == 1:
        arr = np.asarray(_repeated_float(f, 4), np.float32)
    elif dtype_code == 7:
        arr = np.asarray(_repeated_int(f, 7), np.int64)
    elif dtype_code in (6, 9, 10):  # int32/bool/fp16 ride in int32_data
        arr = np.asarray(_repeated_int(f, 5))
        if dtype_code == 10:
            arr = arr.astype(np.uint16).view(np.float16)
        else:
            arr = arr.astype(np_dtype)
    elif dtype_code == 11:
        raw64 = b"".join(r for w, r in f.get(10, []) if w != 0)
        arr = np.frombuffer(raw64, np.float64)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


@dataclasses.dataclass
class OnnxAttr:
    name: str
    value: Any


def _parse_attribute(buf: bytes) -> OnnxAttr:
    f = _decode_message(buf)
    name = _scalar_bytes(f, 1).decode()
    atype = _scalar_int(f, 20, 0)
    if atype == 1:  # FLOAT
        value = struct.unpack("<f", f[2][-1][1])[0]
    elif atype == 2:  # INT
        value = _scalar_int(f, 3)
    elif atype == 3:  # STRING
        value = _scalar_bytes(f, 4).decode(errors="replace")
    elif atype == 4:  # TENSOR
        value = _parse_tensor(f[5][-1][1])[1]
    elif atype == 6:  # FLOATS
        value = _repeated_float(f, 7)
    elif atype == 7:  # INTS
        value = _repeated_int(f, 8)
    elif atype == 8:  # STRINGS
        value = [raw.decode(errors="replace") for _, raw in f.get(9, [])]
    else:  # infer from whichever field is present (legacy exporters omit type)
        if 3 in f:
            value = _scalar_int(f, 3)
        elif 2 in f:
            value = struct.unpack("<f", f[2][-1][1])[0]
        elif 8 in f:
            value = _repeated_int(f, 8)
        elif 4 in f:
            value = _scalar_bytes(f, 4).decode(errors="replace")
        else:
            value = None
    return OnnxAttr(name, value)


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Any]
    name: str = ""


@dataclasses.dataclass
class OnnxGraph:
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    input_names: list[str]
    output_names: list[str]
    input_shapes: dict[str, list[int]]
    name: str = ""


def _parse_value_info(buf: bytes) -> tuple[str, list[int]]:
    f = _decode_message(buf)
    name = _scalar_bytes(f, 1).decode()
    shape: list[int] = []
    type_buf = _scalar_bytes(f, 2, None)
    if type_buf:
        tf = _decode_message(type_buf)
        tt = tf.get(1)  # TypeProto.tensor_type
        if tt:
            ttf = _decode_message(tt[-1][1])
            sh = ttf.get(2)  # TensorTypeProto.shape
            if sh:
                for _, dim_buf in _decode_message(sh[-1][1]).get(1, []):
                    df = _decode_message(dim_buf)
                    shape.append(_scalar_int(df, 1, -1) if 1 in df else -1)
    return name, shape


def _parse_graph(buf: bytes) -> OnnxGraph:
    f = _decode_message(buf)
    nodes = []
    for _, nbuf in f.get(1, []):
        nf = _decode_message(nbuf)
        nodes.append(
            OnnxNode(
                op_type=_scalar_bytes(nf, 4).decode(),
                inputs=[raw.decode() for _, raw in nf.get(1, [])],
                outputs=[raw.decode() for _, raw in nf.get(2, [])],
                attrs={
                    a.name: a.value
                    for a in (_parse_attribute(abuf) for _, abuf in nf.get(5, []))
                },
                name=_scalar_bytes(nf, 3).decode(),
            )
        )
    initializers = dict(_parse_tensor(tbuf) for _, tbuf in f.get(5, []))
    inputs, shapes = [], {}
    for _, vbuf in f.get(11, []):
        nm, sh = _parse_value_info(vbuf)
        if nm not in initializers:  # old exporters list weights as inputs too
            inputs.append(nm)
            shapes[nm] = sh
    outputs = [_parse_value_info(vbuf)[0] for _, vbuf in f.get(12, [])]
    return OnnxGraph(nodes, initializers, inputs, outputs, shapes,
                     name=_scalar_bytes(f, 2).decode())


def parse_onnx(path: str) -> OnnxGraph:
    """Parse a serialized ONNX ModelProto into an :class:`OnnxGraph`."""
    with open(path, "rb") as fh:
        return parse_onnx_bytes(fh.read(), path)


def parse_onnx_bytes(buf: bytes, source: str = "<bytes>") -> OnnxGraph:
    """``parse_onnx`` of a ModelProto held in memory."""
    model = _decode_message(buf)
    if 7 not in model:
        raise ValueError(f"{source}: no GraphProto (field 7) — not an ONNX model?")
    return _parse_graph(model[7][-1][1])



# ---------------------------------------------------------------------------
# torch executor
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {
    np.dtype(k): v
    for k, v in {
        np.float32: torch.float32, np.uint8: torch.uint8, np.int8: torch.int8, np.int16: torch.int16,
        np.int32: torch.int32, np.int64: torch.int64, np.bool_: torch.bool, np.float16: torch.float16,
        np.float64: torch.float64,
    }.items()
}


def _is_static(x) -> bool:
    """Static (shape-arithmetic) value: numpy or a Python number, not a
    tensor."""
    return isinstance(x, (np.ndarray, np.generic, int, float, list, tuple))


class _Env(dict):
    """The values of one run by name, plus the device of its data and the
    module's cache of constants already converted for that device."""

    def __init__(self, device: torch.device, cache: dict, cacheable: frozenset, file_params: dict):
        super().__init__()
        self.device = device
        self.file_params = file_params  # the float initializers as the file holds them (numpy)
        self._cache = cache
        self._cacheable = cacheable

    def t(self, name: str) -> torch.Tensor:
        """The value ``name`` as a tensor on the run's device. Initializers
        and ``Constant`` outputs are converted once per device."""
        v = self[name]
        if isinstance(v, torch.Tensor):
            return v
        if name in self._cacheable:
            key = (name, self.device)
            if key not in self._cache:
                self._cache[key] = _as_tensor(v, self.device)
            return self._cache[key]
        return _as_tensor(v, self.device)


def _as_tensor(v, device) -> torch.Tensor:
    arr = np.asarray(v)
    if arr.dtype == np.float64:  # jnp.asarray without x64: float32
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device)  # a copy: parsed arrays are read-only views of the file


def _static(env: _Env, name: str) -> np.ndarray:
    """A shape-like input (a Reshape target, Slice bounds, a TopK k ...) as
    numpy. Such a value must have stayed static: reading it back from a
    tensor would wait for the device, so that is refused. A float
    initializer (Resize scales, a Pad value) is read as the file holds it."""
    v = env[name]
    if isinstance(v, torch.Tensor) and name in env.file_params:
        return np.asarray(env.file_params[name])
    if isinstance(v, torch.Tensor):
        raise NotImplementedError(
            f"the shape-like value {name!r} depends on tensor data; the executor keeps shape arithmetic in numpy"
        )
    return np.asarray(v)


def _operand(env: _Env, name: str):
    """A binary op's operand: tensors as they are, static 0-d values as
    Python numbers (weakly typed, so the tensor's dtype wins, and no copy to
    the device is made), other static arrays as tensors."""
    v = env[name]
    if isinstance(v, torch.Tensor):
        return v
    arr = np.asarray(v)
    return arr.item() if arr.ndim == 0 else env.t(name)


def _scalar_like(value, other: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-d tensor beside ``other``: filled on the
    device, in ``other``'s dtype unless a float meets an integer tensor."""
    dtype = other.dtype
    if isinstance(value, float) and not other.is_floating_point():
        dtype = torch.float32
    return torch.full((), value, dtype=dtype, device=other.device)


def _pool_padding(attrs, spatial_rank):
    pads = attrs.get("pads")
    if pads:
        half = len(pads) // 2
        return [(int(pads[i]), int(pads[i + half])) for i in range(spatial_rank)]
    auto = attrs.get("auto_pad", "NOTSET")
    if auto in ("NOTSET", "", "VALID"):
        return [(0, 0)] * spatial_rank
    raise NotImplementedError(f"auto_pad={auto!r}")


def _pad_spatial(x: torch.Tensor, padding, value: float = 0.0) -> torch.Tensor:
    """Pad the trailing spatial axes by [(before, after), ...]."""
    if not any(p for pair in padding for p in pair):
        return x
    flat = [p for pair in reversed(padding) for p in pair]
    return F.pad(x, flat, value=value)


def _op_conv(env, node):
    x = env.t(node.inputs[0])
    w = env.t(node.inputs[1])
    b = env.t(node.inputs[2]) if len(node.inputs) > 2 and node.inputs[2] else None
    a = node.attrs
    rank = x.dim() - 2
    strides = [int(s) for s in a.get("strides", [1] * rank)]
    dilations = [int(d) for d in a.get("dilations", [1] * rank)]
    groups = int(a.get("group", 1))
    if a.get("auto_pad") in ("SAME_UPPER", "SAME_LOWER"):
        padding = []
        for n_in, k, s, d in zip(x.shape[2:], w.shape[2:], strides, dilations):
            total = max((-(-n_in // s) - 1) * s + (k - 1) * d + 1 - n_in, 0)
            padding.append((total // 2, total - total // 2))
    else:
        padding = _pool_padding(a, rank)
    if all(p0 == p1 for p0, p1 in padding):
        pad_arg = [p0 for p0, _ in padding]
    else:
        x, pad_arg = _pad_spatial(x, padding), 0
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[rank]
    return conv(x, w, b, stride=strides, padding=pad_arg, dilation=dilations, groups=groups)


def _op_batchnorm(env, node):
    x = env.t(node.inputs[0])
    scale, bias, mean, var = (env.t(i) for i in node.inputs[1:5])
    eps = node.attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(var.float() + eps)
    return (x - mean.reshape(shape)) * (scale * inv).reshape(shape) + bias.reshape(shape)


def _op_gemm(env, node):
    a_ = env.t(node.inputs[0])
    b_ = env.t(node.inputs[1])
    alpha = node.attrs.get("alpha", 1.0)
    beta = node.attrs.get("beta", 1.0)
    a_ = a_.T if node.attrs.get("transA", 0) else a_
    b_ = b_.T if node.attrs.get("transB", 0) else b_
    out = alpha * (a_ @ b_)
    if len(node.inputs) > 2:
        out = out + beta * env.t(node.inputs[2])
    return out


def _op_resize(env, node):
    # Resize (opset 10+) / Upsample (opset <10): nearest, linear or cubic,
    # scales or explicit sizes, with jax.image.resize's semantics.
    x = env.t(node.inputs[0])
    a = node.attrs
    mode = a.get("mode", "nearest")
    sizes = None
    if node.op_type == "Upsample":
        scales = a.get("scales") or _static(env, node.inputs[1])
    else:
        scales = None
        if len(node.inputs) == 2 and node.inputs[1] in env:
            # opset-10 Resize(X, scales) two-input form
            s = _static(env, node.inputs[1])
            scales = s if s.size else None
        if scales is None and len(node.inputs) > 2 and node.inputs[2] and node.inputs[2] in env:
            s = _static(env, node.inputs[2])
            scales = s if s.size else None
        if scales is None and len(node.inputs) > 3 and node.inputs[3] in env:
            sizes = [int(v) for v in _static(env, node.inputs[3])]
        if scales is None and sizes is None:
            raise NotImplementedError(f"Resize node {node.name!r}: neither scales nor sizes resolved")
    if sizes is None:
        scales = [float(s) for s in np.asarray(scales).reshape(-1)]
        sizes = [int(round(d * s)) for d, s in zip(x.shape, scales)]
    if mode not in ("nearest", "linear", "cubic"):
        raise KeyError(mode)
    return resize_nd(x, sizes, mode)


def _reduce_axes(env, n):
    """Reduce* axes: the `axes` attribute (opset < 18) or the optional second
    input (opset >= 18). Absent/empty axes reduce over ALL axes unless the
    node sets noop_with_empty_axes=1, in which case the op is identity."""
    axes = None
    if "axes" in n.attrs:
        ax = np.asarray(n.attrs["axes"]).reshape(-1)
        axes = tuple(int(a) for a in ax) if ax.size else None
    elif len(n.inputs) > 1 and n.inputs[1] and n.inputs[1] in env:
        ax = _static(env, n.inputs[1]).reshape(-1)
        axes = tuple(int(a) for a in ax) if ax.size else None
    if axes is not None:
        return axes
    if n.attrs.get("noop_with_empty_axes", 0):
        return ()
    return tuple(range(env.t(n.inputs[0]).dim()))


def _reduce(fn):
    def op(env, n):
        x = env.t(n.inputs[0])
        axes = _reduce_axes(env, n)
        if not axes:
            return x
        return fn(x, dim=axes, keepdim=bool(n.attrs.get("keepdims", 1)))

    return op


def _index_pad(x: torch.Tensor, width, mode: str) -> torch.Tensor:
    """``jnp.pad`` in "reflect" or "edge" mode as an index map per axis."""
    for axis, (before, after) in enumerate(width):
        if not (before or after):
            continue
        n = x.shape[axis]
        pos = torch.arange(-before, n + after, device=x.device)
        if mode == "edge" or n == 1:
            idx = pos.clamp(0, n - 1)
        else:
            period = 2 * (n - 1)
            m = pos % period
            idx = torch.where(m < n, m, period - m)
        x = x.index_select(axis, idx)
    return x


def _op_pad(env, n):
    """Pad with mode support (constant/reflect/edge) and the opset-11+
    constant_value input; raises on unsupported modes instead of silently
    zero-padding."""
    x = env.t(n.inputs[0])
    pads = np.asarray(n.attrs["pads"] if "pads" in n.attrs else _static(env, n.inputs[1])).reshape(-1)
    if len(n.inputs) > 3 and n.inputs[3] and n.inputs[3] in env:
        # opset-18 optional `axes` input: pads has 2*len(axes) entries in axes
        # order; expand to full rank (unlisted dims unpadded)
        axes = [int(a) % x.dim() for a in _static(env, n.inputs[3]).reshape(-1)]
        starts, ends = np.split(pads, 2)
        full = np.zeros(2 * x.dim(), dtype=np.int64)
        for a, s, e in zip(axes, starts, ends):
            full[a], full[x.dim() + a] = s, e
        pads = full
    width = [(int(p0), int(p1)) for p0, p1 in zip(*np.split(pads, 2))]
    mode = n.attrs.get("mode", "constant")
    if isinstance(mode, bytes):
        mode = mode.decode()
    if mode == "constant":
        cval = n.attrs.get("value", 0.0)
        if len(n.inputs) > 2 and n.inputs[2] and n.inputs[2] in env:
            cval = float(_static(env, n.inputs[2]).reshape(()))
        return _pad_spatial(x, width, value=cval)  # every axis is listed, so all are "trailing"
    if mode in ("reflect", "edge"):
        return _index_pad(x, width, mode)
    raise NotImplementedError(f"Pad mode {mode!r} is not supported")


def _binop(fn_np, fn_torch):
    def op(env, node):
        x, y = env[node.inputs[0]], env[node.inputs[1]]
        if _is_static(x) and _is_static(y):
            return fn_np(x, y)
        x, y = _operand(env, node.inputs[0]), _operand(env, node.inputs[1])
        if not isinstance(x, torch.Tensor):
            x = _scalar_like(x, y)
        elif not isinstance(y, torch.Tensor):
            y = _scalar_like(y, x)
        return fn_torch(x, y)

    return op


def _op_pool(env, node, kind: str):
    x = env.t(node.inputs[0])
    a = node.attrs
    rank = x.dim() - 2
    k = [int(v) for v in a["kernel_shape"]]
    strides = [int(v) for v in a.get("strides", [1] * rank)]
    padding = _pool_padding(a, rank)
    if kind == "max":
        pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[rank]
        return pool(_pad_spatial(x, padding, value=float("-inf")), k, stride=strides)
    pool = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[rank]
    total = pool(_pad_spatial(x, padding), k, stride=strides)
    if not any(p for pair in padding for p in pair):
        return total
    # divide by the count of real elements (count_include_pad=False)
    ones = _pad_spatial(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device), padding)
    return total / pool(ones, k, stride=strides)


def _op_grid_sample(env, node):
    """GridSample (opset 16+): X [N,C,H,W], grid [N,Ho,Wo,2] in [-1,1]
    (x, y); bilinear/nearest, zeros/border padding."""
    x = env.t(node.inputs[0])
    grid = env.t(node.inputs[1])
    a = node.attrs
    mode = a.get("mode", "bilinear")
    padding = a.get("padding_mode", "zeros")
    align = bool(a.get("align_corners", 0))
    if mode not in ("bilinear", "nearest") or padding not in ("zeros", "border"):
        raise NotImplementedError(f"GridSample mode={mode!r} padding_mode={padding!r}")
    # F.grid_sample's "nearest" rounds half to even (nearbyint), as jnp.round
    return F.grid_sample(x, grid.to(x.dtype), mode=mode, padding_mode=padding, align_corners=align)


def _op_topk(env, node):
    x = env.t(node.inputs[0])
    k = int(_static(env, node.inputs[1]).reshape(()))
    axis = node.attrs.get("axis", -1)
    largest = node.attrs.get("largest", 1)
    # a stable sort breaks ties toward the lower index, as lax.top_k
    vals, idx = torch.sort(x if largest else -x, dim=axis, descending=True, stable=True)
    vals, idx = vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)
    return (vals if largest else -vals), idx.to(torch.int64)


def _op_layernorm(env, node):
    x = env.t(node.inputs[0])
    scale = env.t(node.inputs[1])
    axis = node.attrs.get("axis", -1)
    eps = node.attrs.get("epsilon", 1e-5)
    axes = tuple(range(axis % x.dim(), x.dim()))
    mu = x.mean(dim=axes, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=axes, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale
    if len(node.inputs) > 2 and node.inputs[2]:
        out = out + env.t(node.inputs[2])
    return out


def _op_slice(env, node):
    x = env[node.inputs[0]]
    a = node.attrs
    if "starts" in a:  # opset 9
        starts, ends = a["starts"], a["ends"]
        axes = a.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    else:  # opset 10+: runtime inputs (must be static)
        starts = [int(v) for v in _static(env, node.inputs[1])]
        ends = [int(v) for v in _static(env, node.inputs[2])]
        axes = (
            [int(v) for v in _static(env, node.inputs[3])]
            if len(node.inputs) > 3 and node.inputs[3]
            else list(range(len(starts)))
        )
        steps = (
            [int(v) for v in _static(env, node.inputs[4])]
            if len(node.inputs) > 4 and node.inputs[4]
            else [1] * len(starts)
        )
    if any(st < 0 for st in steps) and isinstance(x, torch.Tensor):
        raise NotImplementedError("Slice with a negative step on a tensor")
    idx = [slice(None)] * x.ndim
    for ax, s, e, st in zip(axes, starts, ends, steps):
        idx[ax] = slice(s, None if e >= (1 << 31) else e, st)
    return x[tuple(idx)]


def _unary(fn, fn_np=None):
    """A unary op; ``fn_np`` keeps a static input static."""

    def op(env, n):
        x = env[n.inputs[0]]
        if fn_np is not None and _is_static(x):
            return fn_np(x)
        return fn(env.t(n.inputs[0]))

    return op


def _shape_op(fn_torch, fn_np):
    """Reshape / Transpose / Flatten / Expand: numpy on a static input (a
    shape vector being rearranged), torch on data."""

    def op(env, n):
        x = env[n.inputs[0]]
        return fn_np(env, n, np.asarray(x)) if _is_static(x) else fn_torch(env, n, x)

    return op


def _target(env, n, x):
    """A Reshape target with ONNX's 0 (copy the input's dimension) resolved."""
    return [x.shape[i] if d == 0 else d for i, d in enumerate(int(v) for v in _static(env, n.inputs[1]).reshape(-1))]


def _perm(n, x):
    perm = n.attrs.get("perm")
    return tuple(perm) if perm is not None else tuple(reversed(range(x.ndim)))


def _flat_shape(n, x):
    return (int(np.prod(x.shape[: n.attrs.get("axis", 1)])), -1)


def _expand_shape(env, n, x):
    return np.broadcast_shapes(tuple(x.shape), tuple(int(v) for v in _static(env, n.inputs[1])))


def _axes_arg(env, n, default=None):
    if n.attrs.get("axes"):
        return tuple(n.attrs["axes"])
    if len(n.inputs) > 1 and n.inputs[1]:
        return tuple(int(v) for v in _static(env, n.inputs[1]).reshape(-1))
    return default


def _op_unsqueeze(env, n):
    x, axes = env[n.inputs[0]], _axes_arg(env, n)
    if _is_static(x):
        return np.expand_dims(np.asarray(x), axes)
    rank = x.dim() + len(axes)
    for ax in sorted(a % rank for a in axes):
        x = x.unsqueeze(ax)
    return x


def _op_squeeze(env, n):
    x, axes = env[n.inputs[0]], _axes_arg(env, n, ())
    if _is_static(x):
        return np.squeeze(np.asarray(x), axes or None)
    return x.squeeze(axes) if axes else x.squeeze()


def _op_clip(env, n):
    def bound(attr, i):
        if attr in n.attrs:
            return n.attrs[attr]
        if len(n.inputs) > i and n.inputs[i] and n.inputs[i] in env:
            return _operand(env, n.inputs[i])
        return None

    x = env.t(n.inputs[0])
    lo, hi = bound("min", 1), bound("max", 2)
    if lo is not None:
        x = torch.clamp(x, min=lo)
    if hi is not None:
        x = torch.clamp(x, max=hi)
    return x


def _op_prelu(env, n):
    x, slope = env.t(n.inputs[0]), env.t(n.inputs[1])
    if slope.dim() == 1:
        slope = slope.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, slope * x)


def _op_concat(env, n):
    axis = n.attrs.get("axis", 0)
    if all(_is_static(env[i]) for i in n.inputs):
        return np.concatenate([env[i] for i in n.inputs], axis=axis)
    parts = [env.t(i) for i in n.inputs]
    dtype = parts[0].dtype
    for p in parts[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    return torch.cat([p.to(dtype) for p in parts], dim=axis)


def _op_cast(env, n):
    x = env[n.inputs[0]]
    to = _TENSOR_DTYPES[n.attrs["to"]]
    if _is_static(x):
        return np.asarray(x).astype(to)
    return x.to(_TORCH_DTYPES[np.dtype(to)])


def _op_gather(env, n):
    x, idx = env[n.inputs[0]], env[n.inputs[1]]
    axis = n.attrs.get("axis", 0)
    if _is_static(x) and _is_static(idx):
        return np.take(np.asarray(x), np.asarray(idx), axis=axis)
    x = env.t(n.inputs[0])
    if _is_static(idx):
        idx = np.asarray(idx)
        if idx.ndim == 0:
            return x.select(axis, int(idx) % x.shape[axis])
        idx_t = env.t(n.inputs[1])
    else:
        idx_t = idx
    idx_t = idx_t.to(torch.long)
    idx_t = torch.where(idx_t < 0, idx_t + x.shape[axis], idx_t)
    out = x.index_select(axis, idx_t.reshape(-1))
    return out.reshape(x.shape[:axis] + tuple(idx_t.shape) + x.shape[axis + 1 :])


def _op_where(env, n):
    c, x, y = (env[i] for i in n.inputs[:3])
    if all(_is_static(v) for v in (c, x, y)):
        return np.where(c, x, y)
    x, y = _operand(env, n.inputs[1]), _operand(env, n.inputs[2])
    return torch.where(env.t(n.inputs[0]), x, y)


def _op_not(env, n):
    x = env[n.inputs[0]]
    return ~x if isinstance(x, torch.Tensor) else np.logical_not(x)


_OPS: dict[str, Callable] = {
    "Conv": _op_conv,
    "BatchNormalization": _op_batchnorm,
    "Gemm": _op_gemm,
    "Resize": _op_resize,
    "Upsample": _op_resize,
    "Relu": _unary(torch.relu),
    "LeakyRelu": lambda env, n: F.leaky_relu(env.t(n.inputs[0]), n.attrs.get("alpha", 0.01)),
    "PRelu": _op_prelu,
    "Sigmoid": _unary(torch.sigmoid),
    "Softmax": lambda env, n: torch.softmax(env.t(n.inputs[0]), dim=n.attrs.get("axis", -1)),
    "Exp": _unary(torch.exp, np.exp),
    "Sqrt": _unary(torch.sqrt, np.sqrt),
    "Tanh": _unary(torch.tanh, np.tanh),
    "Clip": _op_clip,
    "Add": _binop(np.add, torch.add),
    "Sub": _binop(np.subtract, torch.sub),
    "Mul": _binop(np.multiply, torch.mul),
    "Div": _binop(np.divide, torch.div),
    "MatMul": lambda env, n: env.t(n.inputs[0]) @ env.t(n.inputs[1]),
    "MaxPool": lambda env, n: _op_pool(env, n, "max"),
    "AveragePool": lambda env, n: _op_pool(env, n, "avg"),
    "GlobalAveragePool": lambda env, n: env.t(n.inputs[0]).mean(
        dim=tuple(range(2, env.t(n.inputs[0]).dim())), keepdim=True
    ),
    "Concat": _op_concat,
    "Reshape": _shape_op(lambda env, n, x: x.reshape(_target(env, n, x)), lambda env, n, x: x.reshape(_target(env, n, x))),
    "Transpose": _shape_op(lambda env, n, x: x.permute(*_perm(n, x)), lambda env, n, x: x.transpose(_perm(n, x))),
    "Flatten": _shape_op(lambda env, n, x: x.reshape(_flat_shape(n, x)), lambda env, n, x: x.reshape(_flat_shape(n, x))),
    "Identity": lambda env, n: env[n.inputs[0]],
    "Dropout": lambda env, n: env[n.inputs[0]],
    "Cast": _op_cast,
    "Shape": lambda env, n: np.asarray(tuple(env[n.inputs[0]].shape), np.int64),
    "Gather": _op_gather,
    "Unsqueeze": _op_unsqueeze,
    "Squeeze": _op_squeeze,
    "Constant": lambda env, n: n.attrs.get("value", n.attrs.get("value_float", n.attrs.get("value_int"))),
    "ConstantOfShape": lambda env, n: np.full(
        [int(v) for v in _static(env, n.inputs[0])],
        n.attrs["value"].reshape(-1)[0] if "value" in n.attrs else 0.0,
    ),
    "Slice": _op_slice,
    "Pad": _op_pad,
    "ReduceMean": _reduce(torch.mean),
    "GridSample": _op_grid_sample,
    "LayerNormalization": _op_layernorm,
    "Erf": _unary(torch.erf),
    "Neg": _unary(torch.neg, np.negative),
    "Pow": _binop(np.power, torch.pow),
    "Greater": _binop(np.greater, torch.gt),
    "Less": _binop(np.less, torch.lt),
    "Equal": _binop(np.equal, torch.eq),
    "Not": _op_not,
    "And": _binop(np.logical_and, torch.logical_and),
    "Or": _binop(np.logical_or, torch.logical_or),
    "Where": _op_where,
    "Expand": _shape_op(
        lambda env, n, x: x.expand(_expand_shape(env, n, x)), lambda env, n, x: np.broadcast_to(x, _expand_shape(env, n, x))
    ),
    "Range": lambda env, n: np.arange(
        _static(env, n.inputs[0]).reshape(()),
        _static(env, n.inputs[1]).reshape(()),
        _static(env, n.inputs[2]).reshape(()),
    ),
    "ReduceSum": _reduce(torch.sum),
    "ReduceMax": _reduce(torch.amax),
    "ReduceMin": _reduce(torch.amin),
    "Max": _binop(np.maximum, torch.maximum),
    "Min": _binop(np.minimum, torch.minimum),
    "Floor": _unary(torch.floor, np.floor),
    "Log": _unary(torch.log, np.log),
    "Split": None,  # handled specially (multi-output)
    "TopK": None,  # handled specially (multi-output)
}


class OnnxModule:
    """An imported ONNX graph as a function of torch tensors.

    ``params`` holds every float initializer (the weights) as numpy arrays;
    integer/shape constants are kept apart in ``constants``. Call as
    ``module(params, x)``: ``params`` may hold numpy arrays or tensors
    (``params_on(device)`` gives the latter, converted once); the graph runs
    on the device of ``x``.
    """

    def __init__(self, graph: OnnxGraph):
        self.graph = graph
        self.input_names = graph.input_names
        self.output_names = graph.output_names
        self.params: dict[str, np.ndarray] = {}
        self.constants: dict[str, np.ndarray] = {}
        for name, arr in graph.initializers.items():
            if arr.dtype in (np.float32, np.float16, np.float64):
                self.params[name] = np.asarray(arr)
            else:
                self.constants[name] = np.asarray(arr)
        unsupported = sorted({n.op_type for n in graph.nodes} - set(_OPS) - {"Split"})
        if unsupported:
            raise NotImplementedError(f"ONNX ops not supported by the torch executor: {unsupported}")
        self._cacheable = frozenset(self.constants) | frozenset(
            n.outputs[0] for n in graph.nodes if n.op_type == "Constant"
        )
        self._tensor_cache: dict = {}

    def input_hw(self) -> tuple[int, int] | None:
        """Static (H, W) of the first graph input if the model declares one."""
        if not self.input_names:
            return None
        sh = self.graph.input_shapes.get(self.input_names[0]) or []
        if len(sh) == 4 and sh[2] > 0 and sh[3] > 0:
            return int(sh[2]), int(sh[3])
        return None

    def params_on(self, device) -> dict[str, torch.Tensor]:
        """``params`` as tensors on ``device`` (float64 narrowed to float32)."""
        return {k: _as_tensor(v, torch.device(device)) for k, v in self.params.items()}

    def __call__(self, params: dict, *inputs):
        inputs = [x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)) for x in inputs]
        device = inputs[0].device if inputs else torch.device("cpu")
        env = _Env(device, self._tensor_cache, self._cacheable, self.params)
        env.update(self.constants)
        for name, p in params.items():
            env[name] = p if isinstance(p, torch.Tensor) else _as_tensor(p, device)
        for name, x in zip(self.input_names, inputs):
            env[name] = x
        for node in self.graph.nodes:
            if node.op_type == "TopK":
                vals, idx = _op_topk(env, node)
                env[node.outputs[0]] = vals
                if len(node.outputs) > 1:
                    env[node.outputs[1]] = idx
                continue
            if node.op_type == "Split":
                x = env.t(node.inputs[0])
                axis = node.attrs.get("axis", 0)
                splits = node.attrs.get("split")
                if splits is None and len(node.inputs) > 1 and node.inputs[1]:
                    splits = [int(v) for v in _static(env, node.inputs[1])]
                if splits is None:
                    if x.shape[axis] % len(node.outputs):
                        raise ValueError(f"Split node {node.name!r}: axis {axis} does not divide evenly")
                    splits = x.shape[axis] // len(node.outputs)
                for out_name, part in zip(node.outputs, torch.split(x, splits, dim=axis)):
                    env[out_name] = part
                continue
            fn = _OPS.get(node.op_type)
            if fn is None:
                raise NotImplementedError(f"ONNX op {node.op_type}")
            env[node.outputs[0]] = fn(env, node)
        return tuple(env.t(name) for name in self.output_names)


def import_onnx(path: str) -> OnnxModule:
    """Parse + wrap an ``.onnx`` file as an :class:`OnnxModule`."""
    return OnnxModule(parse_onnx(path))
