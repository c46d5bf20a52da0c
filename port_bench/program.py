"""The bridge to the system under test, ``facedet_tpu_torch``: builds its
detector and enhancer from a configuration and hands it the benchmark's
inputs in its own types. The drivers and nothing else call it.
"""
from __future__ import annotations

import os

import numpy as np

from port_bench.harness import ROOT, family


def detector(config: dict, device, int8: bool = False):
    """The configuration's detector on ``device``, built by its family
    (``families/<family>.py``); ``int8`` switches on the program's own int8
    path, the check's control."""
    return family(config["detector"]["family"]).program(config, device, int8)


def enhancer(config: dict, device):
    from facedet_tpu_torch.engine.enhancer import FaceEnhancer

    e = config["enhancer"]
    return FaceEnhancer(model_name=e["model"], model_path=os.path.join(ROOT, e["weights"]), outscale=e["outscale"],
                        tile=e["tile"], tile_pad=e["tile_pad"], half=e["dtype"] == "bfloat16", device=device)


def sliced_kwargs(config: dict, mix: dict, entry: dict) -> dict:
    """``get_sliced_prediction`` / ``predict_stream_batched`` options."""
    s = config["slicing"]
    kw = dict(slice_height=s["slice"], slice_width=s["slice"], overlap_height_ratio=s["overlap"],
              overlap_width_ratio=s["overlap"], perform_standard_pred=s["standard_pass"],
              postprocess_type=s["postprocess"], postprocess_match_metric=s["match_metric"],
              postprocess_match_threshold=s["match_threshold"], input_format=mix["format"])
    for key in ("postprocess_class_agnostic", "fetch_capacity"):
        if key in entry:
            kw[key] = entry[key]
    return kw


def program_input(item: dict):
    """The benchmark's input as the program takes it: the ``DctImage`` of
    its planes, else the uint8 photo."""
    if "dct" not in item:
        return item["rgb"]
    from facedet_tpu_torch.ops.jpeg_dct import DctImage

    return DctImage(**item["dct"])


def detections(det) -> dict:
    """Program ``Detections`` (host, one image) -> numpy {boxes, scores,
    kpts} of the valid rows, by descending score."""
    valid = det.valid.cpu().numpy().astype(bool)
    return _by_score({k: getattr(det, k).float().cpu().numpy()[valid] for k in ("boxes", "scores", "kpts")})


def batch_detections(det) -> list[dict]:
    """Program ``Detections`` of a batch (host) -> the numpy answer of each
    image, as ``detections`` gives it; the program's tensors can be freed
    once this returns."""
    valid = det.valid.cpu().numpy().astype(bool)
    arrays = {k: getattr(det, k).float().cpu().numpy() for k in ("boxes", "scores", "kpts")}
    return [_by_score({k: v[i][valid[i]] for k, v in arrays.items()}) for i in range(valid.shape[0])]


def _by_score(answer: dict) -> dict:
    order = np.argsort(-answer["scores"], kind="stable")
    return {k: v[order] for k, v in answer.items()}
