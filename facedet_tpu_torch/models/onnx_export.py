"""Export the port's detectors as ``.onnx`` files (counterpart of
facedet_tpu/models/onnx_export.py).

Two layers, as in the JAX module:

  1. a dependency-free protobuf *wire format* encoder, the mirror of
     models/onnx_import.py's decoder (pure Python and numpy, copied from the
     JAX package: the same bytes for the same graph): ``serialize_model`` /
     ``save_onnx`` write any ``OnnxGraph``, one parsed or built by hand;
  2. the generic entry ``export_torch_to_onnx(module, x, ...)``, the
     counterpart of ``export_jax_to_onnx(fn, params, x, ...)``, with its names
     and defaults (input ``input.1``, the given output names, opset 17). It
     lowers the ``nn.Module`` with torch's TorchScript exporter, which writes
     the protobuf in C++ and needs no ``onnx`` package, re-parses the bytes
     into an ``OnnxGraph`` and writes the file through ``save_onnx``.

The JAX module's jaxpr lowering (``_Builder``, ``_lower_*``,
``_walk_jaxpr``, ``_fold_single_use_transposes``) has no counterpart here:
torch's exporter lowers the module itself, and it writes conv weights in
OIHW already, which the JAX lowering reaches only by folding the transposes
around its NHWC convs.

Two model layouts, the ones the import paths consume:

  * ``export_scrfd_onnx``: the insightface SCRFD layout: an NCHW blob
    ``(pix*255 - 127.5)/128`` in (``input.1``), nine outputs out
    (score_8/16/32, bbox_8/16/32, kps_8/16/32), each ``[B, h*w*A, c]``
    anchor-fastest, the scores already sigmoided (engine/scrfd_wrapper.py).
  * ``export_yolo_onnx``: the ultralytics export head ``[B, 4+nc+K*3, A]``
    (``images`` in, ``output0`` out): cxcywh pixel boxes, sigmoided class
    scores, decoded keypoint rows (engine/onnx_wrapper.py).

The graphs are exported at batch 1, as the published checkpoints are, in
float32 on the CPU.
"""
from __future__ import annotations

import io
import struct
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

__all__ = [
    "serialize_model",
    "save_onnx",
    "export_torch_to_onnx",
    "export_scrfd_onnx",
    "export_yolo_onnx",
]

# ---------------------------------------------------------------------------
# protobuf wire-format encoding (mirror of onnx_import's decoder)
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_int(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(int(v))


def _f_bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _f_str(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode())


def _f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(v))


_NP_TO_ONNX_DTYPE = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.uint16): 4, np.dtype(np.int16): 5, np.dtype(np.int32): 6,
    np.dtype(np.int64): 7, np.dtype(np.bool_): 9, np.dtype(np.float16): 10,
    np.dtype(np.float64): 11, np.dtype(np.uint32): 12, np.dtype(np.uint64): 13,
}


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims(1), data_type(2), name(8), raw_data(9). A 0-d
    tensor keeps no dims (the JAX helper's ``np.ascontiguousarray`` makes it
    1-d, so a scalar came back as shape [1])."""
    shape = np.shape(arr)
    arr = np.ascontiguousarray(arr)
    code = _NP_TO_ONNX_DTYPE.get(arr.dtype)
    if code is None:
        raise ValueError(f"initializer {name!r}: unsupported dtype {arr.dtype}")
    out = b"".join(_f_int(1, d) for d in shape)
    out += _f_int(2, code)
    out += _f_str(8, name)
    out += _f_bytes(9, arr.tobytes())
    return out


def encode_attribute(name: str, value: Any) -> bytes:
    """AttributeProto with the explicit type field (20) modern exporters set."""
    out = _f_str(1, name)
    if isinstance(value, bool):
        out += _f_int(20, 2) + _f_int(3, int(value))
    elif isinstance(value, int):
        out += _f_int(20, 2) + _f_int(3, value)
    elif isinstance(value, float):
        out += _f_int(20, 1) + _f_float(2, value)
    elif isinstance(value, str):
        out += _f_int(20, 3) + _f_bytes(4, value.encode())
    elif isinstance(value, np.ndarray):
        out += _f_int(20, 4) + _f_bytes(5, encode_tensor("", value))
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            out += _f_int(20, 6) + b"".join(_f_float(7, v) for v in value)
        else:
            out += _f_int(20, 7) + b"".join(_f_int(8, int(v)) for v in value)
    else:
        raise ValueError(f"attribute {name!r}: unsupported value {value!r}")
    return out


def encode_node(op_type: str, inputs, outputs, attrs: dict, name: str = "") -> bytes:
    out = b"".join(_f_str(1, i) for i in inputs)
    out += b"".join(_f_str(2, o) for o in outputs)
    if name:
        out += _f_str(3, name)
    out += _f_str(4, op_type)
    out += b"".join(_f_bytes(5, encode_attribute(k, v)) for k, v in attrs.items())
    return out


def encode_value_info(name: str, shape, elem_type: int = 1) -> bytes:
    dims = b"".join(_f_bytes(1, _f_int(1, d)) for d in shape)
    tensor_type = _f_int(1, elem_type) + _f_bytes(2, dims)
    type_proto = _f_bytes(1, tensor_type)
    return _f_str(1, name) + _f_bytes(2, type_proto)


def serialize_model(graph, opset: int = 17, ir_version: int = 8,
                    producer: str = "facedet_tpu_torch") -> bytes:
    """Serialize an onnx_import.OnnxGraph-shaped object (with node attrs and
    numpy initializers) into ModelProto bytes."""
    g = b"".join(
        _f_bytes(1, encode_node(n.op_type, n.inputs, n.outputs, n.attrs, n.name))
        for n in graph.nodes
    )
    g += _f_str(2, graph.name or "facedet_tpu_graph")
    g += b"".join(
        _f_bytes(5, encode_tensor(nm, np.asarray(arr)))
        for nm, arr in graph.initializers.items()
    )
    for nm in graph.input_names:
        shape = graph.input_shapes.get(nm, [])
        g += _f_bytes(11, encode_value_info(nm, shape))
    for nm in graph.output_names:
        g += _f_bytes(12, encode_value_info(nm, []))
    model = _f_int(1, ir_version)
    model += _f_str(3, producer)
    model += _f_bytes(7, g)
    model += _f_bytes(8, _f_str(1, "") + _f_int(2, opset))  # opset_import
    return model


def save_onnx(graph, path: str, opset: int = 17) -> None:
    """Write an ``OnnxGraph`` (models/onnx_import.py) as an ``.onnx`` file."""
    with open(path, "wb") as fh:
        fh.write(serialize_model(graph, opset=opset))


# ---------------------------------------------------------------------------
# torch module -> ONNX graph
# ---------------------------------------------------------------------------


def _torchscript_export(module: nn.Module, args, f, opset: int, input_names, output_names) -> None:
    """``torch.onnx.export`` through the TorchScript serializer into the
    binary file object ``f``, nothing folded. Its last step merges
    onnxscript functions into the file and is the only part that needs the
    ``onnx`` package; no model here has such functions, so the step is
    skipped."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda proto, custom_opsets: proto
    try:
        with torch.no_grad():
            torch.onnx.export(module.eval(), args, f, opset_version=opset, dynamo=False,
                              input_names=input_names, output_names=output_names,
                              do_constant_folding=False)
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


def export_torch_to_onnx(
    module: nn.Module,
    x: torch.Tensor,
    path: Optional[str] = None,
    *,
    input_name: str = "input.1",
    output_names: Optional[list[str]] = None,
    graph_name: str = "facedet_tpu_torch",
    opset: int = 17,
):
    """Lower ``module(x)`` to an ONNX graph: ``x`` becomes the single graph
    input ``input_name``, each parameter and buffer of the module one
    initializer under its own name (nothing folded, as the JAX entry makes
    each leaf of ``params`` one), the outputs take ``output_names`` (in
    order) where given. Returns the parsed ``OnnxGraph`` and, when ``path``
    is given, writes it there with ``save_onnx``."""
    from facedet_tpu_torch.models.onnx_import import parse_onnx_bytes

    buf = io.BytesIO()
    _torchscript_export(module, x, buf, opset, [input_name], output_names)
    graph = parse_onnx_bytes(buf.getvalue(), "torch.onnx.export")
    graph.name = graph_name
    # the exporter merges initializers of equal value and reads the copies
    # through Identity nodes: give each parameter its own initializer again
    named = {name for name, _ in module.named_parameters()} | {name for name, _ in module.named_buffers()}
    kept = []
    for node in graph.nodes:
        if node.op_type == "Identity" and node.inputs[0] in graph.initializers and node.outputs[0] in named:
            graph.initializers[node.outputs[0]] = graph.initializers[node.inputs[0]].copy()
        else:
            kept.append(node)
    graph.nodes = kept
    if path:
        save_onnx(graph, path, opset=opset)
    return graph


class _ScrfdExport(nn.Module):
    """``Scrfd`` behind insightface's graph interface. GroupNorm is written
    out as mean / variance arithmetic: the exporter would otherwise emit
    ``InstanceNormalization``, which the importer does not bind."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    @staticmethod
    def _group_norm(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = x.reshape(b, gn.num_groups, -1)
        mu = g.mean(dim=-1, keepdim=True)
        var = ((g - mu) ** 2).mean(dim=-1, keepdim=True)
        g = (g - mu) / torch.sqrt(var + gn.eps)
        return g.reshape(b, c, h, w) * gn.weight.reshape(1, c, 1, 1) + gn.bias.reshape(1, c, 1, 1)

    def forward(self, blob):
        m = self.model
        feats = m.neck(m.backbone(blob))
        head = m.head
        per_level = []
        for i, x in enumerate(feats):
            for d in range(head.head_depth):
                x = getattr(head, f"l{i}_conv{d}")(x)
                x = torch.relu(self._group_norm(getattr(head, f"l{i}_gn{d}"), x))
            per_level.append(x)
        b = blob.shape[0]
        outs = []
        for key, width, act in (("cls", 1, torch.sigmoid), ("box", 4, None), ("kps", 2 * m.cfg.num_keypoints, None)):
            for i, x in enumerate(per_level):
                y = getattr(head, f"l{i}_{key}")(x).permute(0, 2, 3, 1).reshape(b, -1, width)
                outs.append(act(y) if act else y)
        return tuple(outs)


def export_scrfd_onnx(model, image_size: int = 640, path: Optional[str] = None, opset: int = 17):
    """``model`` (a float32 ``models.scrfd.Scrfd`` on the CPU) in
    insightface's nine-output layout at ``image_size`` x ``image_size``:
    returns the graph, written to ``path`` when given."""
    from facedet_tpu_torch.models.scrfd import STRIDES

    names = [f"{k}_{s}" for k in ("score", "bbox", "kps") for s in STRIDES]
    blob = torch.zeros(1, 3, image_size, image_size)
    return export_torch_to_onnx(_ScrfdExport(model), blob, path, input_name="input.1",
                                output_names=names, graph_name="scrfd", opset=opset)


class _YoloExport(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        from facedet_tpu_torch.models.yolo_decode import decode_predictions

        preds = decode_predictions(self.model.forward_nchw(x))
        x1, y1, x2, y2 = preds["boxes"].split(1, dim=-1)
        rows = [(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1, preds["scores"]]
        if "kpts" in preds:
            rows.append(preds["kpts"].flatten(2))
        return torch.cat(rows, dim=-1).transpose(1, 2)


def export_yolo_onnx(model, image_size: int = 640, path: Optional[str] = None, opset: int = 17):
    """``model`` (a float32 ``models.yolov11.YoloV11`` on the CPU) with the
    ultralytics export head ``[B, 4+nc+K*3, A]`` at ``image_size``: returns
    the graph, written to ``path`` when given."""
    x = torch.zeros(1, 3, image_size, image_size)
    return export_torch_to_onnx(_YoloExport(model), x, path, input_name="images",
                                output_names=["output0"], graph_name="yolov11", opset=opset)
