"""WIDERFACE evaluation and image quality (counterpart of facedet_tpu/eval/)."""
from facedet_tpu_torch.eval.bbox_overlaps import bbox_overlaps
from facedet_tpu_torch.eval.coco_map import coco_map
from facedet_tpu_torch.eval.dual import DualWiderFaceEvaluator
from facedet_tpu_torch.eval.widerface_official import OfficialWiderFaceEvaluator, voc_ap

__all__ = ["bbox_overlaps", "coco_map", "OfficialWiderFaceEvaluator", "voc_ap", "DualWiderFaceEvaluator"]
