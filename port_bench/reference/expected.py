"""The reference's answer for one input of a cell, by the cell's pipeline
(the method named by the cell's ``reference``: ``sliced`` or
``enhance_first``), in float32 with TF32 off.

Inputs are the benchmark's own (``traffic.make``): the uint8 photo and, for
the ``dct420s`` format, its quantized DCT planes, which are what the program
is handed. The detector's per-tile function is its family's
(``families/<family>.py``), over the weights that the family resolves; the
enhancer's weights are read from the configuration's ``.npz``.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from port_bench import harness, weights
from port_bench.reference import ingest, rrdb, sahi


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN, restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    def __init__(self, config: dict, root: str, device):
        self.cfg, self.device = config, torch.device(device)
        self.detect_tiles = harness.family(config["detector"]["family"]).reference(config, root, self.device)
        self.sr = None
        if "enhancer" in config:
            enh = config["enhancer"]
            self.sr = rrdb.RRDB(weights.load_npz(os.path.join(root, enh["weights"]), self.device),
                                enh["scale"], enh["num_block"])

    def detect(self, canvas: torch.Tensor, h: int, w: int, fetch: int = 0) -> dict:
        s = self.cfg["slicing"]
        if s.get("policy") == "fixed_grid":
            sh, sw = sahi.fixed_grid_slices(h, w)
        else:
            sh = sw = s["slice"]
        return sahi.sliced_detect(self.detect_tiles, canvas, h, w, sh, sw,
                                  conf=self.cfg["detector"]["confidence_threshold"],
                                  img_size=self.cfg["detector"]["image_size"], overlap=s["overlap"],
                                  match_threshold=s["match_threshold"], fetch=fetch)

    @torch.inference_mode()
    def sliced(self, item: dict, fetch: int = 0) -> dict:
        with exact_float32():
            h, w = item["rgb"].shape[:2]
            _, _, canvas_hw = sahi.slice_grid(h, w, self.cfg["slicing"]["slice"], self.cfg["slicing"]["slice"],
                                              self.cfg["slicing"]["overlap"])
            if "dct" in item:
                canvas = ingest.dct_canvas(item["dct"], canvas_hw, self.device)
            else:
                canvas = ingest.rgb_canvas(item["rgb"], canvas_hw, self.device)
            return self.detect(canvas, h, w, fetch)

    @torch.inference_mode()
    def enhance_first(self, item: dict, fetch: int = 0) -> dict:
        """Detections in the original image's coordinates and the enhanced
        image as uint8."""
        with exact_float32():
            img = torch.from_numpy(np.ascontiguousarray(item["rgb"])).to(self.device).permute(2, 0, 1).float() / 255.0
            enh = self.cfg["enhancer"]
            up = rrdb.tiled(self.sr, img, enh["tile"], enh["tile_pad"])
            eh, ew = up.shape[1:]
            sh, sw = sahi.fixed_grid_slices(eh, ew)
            _, _, canvas_hw = sahi.slice_grid(eh, ew, sh, sw, self.cfg["slicing"]["overlap"])
            canvas = torch.zeros((3, *canvas_hw), dtype=torch.float32, device=self.device)
            canvas[:, :eh, :ew] = up
            out = self.detect(canvas, eh, ew)
            scale = np.float32(enh["outscale"])
            h, w = item["rgb"].shape[:2]
            out["boxes"] = np.clip(out["boxes"] / scale, 0, max(h, w))
            out["kpts"][..., :2] /= scale
            out["image"] = (up * 255.0).round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy()
            return out
