"""Export the port's detectors as ``.onnx`` files with torch's own exporter.

Where the JAX package lowers a jaxpr to ONNX (facedet_tpu/models/
onnx_export.py), the port traces the ``nn.Module`` with torch's TorchScript
exporter, which writes the protobuf in C++ and needs no ``onnx`` package.
Two layouts, the ones the import paths consume:

  * ``export_scrfd_onnx``: the insightface SCRFD layout: an NCHW blob
    ``(pix*255 - 127.5)/128`` in, nine outputs out (score_8/16/32,
    bbox_8/16/32, kps_8/16/32), each ``[B, h*w*A, c]`` anchor-fastest, the
    scores already sigmoided (engine/scrfd_wrapper.py).
  * ``export_yolo_onnx``: the ultralytics export head ``[B, 4+nc+K*3, A]``:
    cxcywh pixel boxes, sigmoided class scores, decoded keypoint rows
    (engine/onnx_wrapper.py).

The graphs are exported at batch 1, as the published checkpoints are, in
float32 on the CPU.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["export_onnx", "export_scrfd_onnx", "export_yolo_onnx"]


def export_onnx(module: nn.Module, args, path: str, opset: int = 16) -> None:
    """``torch.onnx.export`` through the TorchScript serializer. Its last
    step merges onnxscript functions into the file and is the only part that
    needs the ``onnx`` package; no model here has such functions, so the
    step is skipped."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda proto, custom_opsets: proto
    try:
        with torch.no_grad():
            torch.onnx.export(module.eval(), args, path, opset_version=opset, dynamo=False)
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


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


def export_scrfd_onnx(model, image_size: int, path: str, opset: int = 16) -> None:
    """Write ``model`` (a float32 ``models.scrfd.Scrfd`` on the CPU) in
    insightface's nine-output layout at ``image_size`` x ``image_size``."""
    export_onnx(_ScrfdExport(model), torch.zeros(1, 3, image_size, image_size), path, opset)


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


def export_yolo_onnx(model, image_size: int, path: str, opset: int = 16) -> None:
    """Write ``model`` (a float32 ``models.yolov11.YoloV11`` on the CPU) with
    the ultralytics export head ``[B, 4+nc+K*3, A]`` at ``image_size``."""
    export_onnx(_YoloExport(model), torch.zeros(1, 3, image_size, image_size), path, opset)
