"""YOLO11-pose (Ultralytics ``yolo11-pose.yaml``): the program's
``YoloV11PoseDetectionModel``, the plain reference's forward (``reference/
yolo.py``) with the per-tile confidence filter, top-300 and IoU-0.7 NMS
(``reference/sahi.tile_detections``), and the FLOPs of the published layout
(``flops.yolo11_pose_flops``). Weights: a flax ``.npz`` path only, as the
repository holds them."""
from __future__ import annotations

from port_bench import flops as counts
from port_bench import weights


def _weights(det: dict):
    if weights.seeded(det["weights"]):
        raise ValueError("the yolo11-pose family reads its weights from an .npz path, not from a seed")
    return det["weights"]


def program(config: dict, device, int8: bool = False):
    """The configuration's detector on ``device``; ``int8`` switches on the
    program's own int8 path (``models.quantize.quantize_detector``), the
    check's control."""
    from facedet_tpu_torch import YoloV11PoseDetectionModel

    from port_bench.harness import ROOT

    d = config["detector"]
    model = YoloV11PoseDetectionModel(model_path=weights.path(_weights(d), ROOT), scale=d["scale"],
                                      image_size=d["image_size"], dtype=d["dtype"], device=device,
                                      confidence_threshold=d["confidence_threshold"])
    if int8:
        from facedet_tpu_torch.models.quantize import quantize_detector

        quantize_detector(model)
    return model


def reference(config: dict, root: str, device):
    """``(tiles [B, 3, h, w] float32, conf)`` -> per tile numpy {boxes,
    scores, kpts} in tile pixels."""
    from port_bench.reference import sahi, yolo

    net = yolo.Yolo(weights.tensors(weights.arrays(_weights(config["detector"]), root), device))
    return lambda tiles, conf: sahi.tile_detections(net, yolo.decode, tiles, conf)


def flops(h: int, w: int, det: dict) -> float:
    return counts.yolo11_pose_flops(h, w, det["scale"], det["num_classes"], det["num_keypoints"])
