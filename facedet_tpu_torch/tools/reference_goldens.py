"""Recover golden detections from the reference repo's committed outputs.

The reference commits real Streamlit run artifacts (reference:
temp_streamlit/<image>/ — temp_sahi_input.jpg is the untouched uploaded
WIDERFACE image; crops/ holds every detected face saved as
``{name}_face_{i}_conf_{score:.2f}.jpg`` by utils/visualization.py:185-223).
Confidences live in the filenames; positions are recovered here by normalized
cross-correlation of each crop against its source image. The result is a
goldens JSON — (bbox, conf) per face per image — produced by the reference's
*actual trained-model runs*, usable as a parity oracle the moment pretrained
weights are loaded into this framework (models/convert.py / onnx_import.py).

This is the only accuracy ground truth available on a zero-egress host: the
reference publishes no weights and no GT .mat files, but its committed crops
pin down exactly what its pipeline detected on real WIDERFACE images.

Usage:
    python -m facedet_tpu_torch.tools.reference_goldens \
        --ref-dir reference/temp_streamlit --out goldens.json \
        [--max-crops 80] [--min-ncc 0.85]

Compare a run against the goldens with eval/reference_parity.py.

Counterpart of facedet_tpu/tools/reference_goldens.py, copied: the search is
host code there as well (numpy and ``scipy.signal.fftconvolve``), so the
same files give the same goldens JSON byte for byte.
"""
from __future__ import annotations

import argparse
import json
import os
import re
from typing import Optional

import numpy as np

__all__ = [
    "parse_crop_name",
    "locate_crop",
    "extract_image_goldens",
    "discover_artifact_dirs",
    "extract_goldens",
    "main",
]

_CROP_RE = re.compile(r"_face_(\d+)_conf_([0-9.]+)\.(?:jpg|jpeg|png)$", re.I)


def parse_crop_name(fname: str) -> Optional[tuple[int, float]]:
    """``..._face_3_conf_0.77.jpg`` -> (3, 0.77); None if not a crop file."""
    m = _CROP_RE.search(fname)
    if not m:
        return None
    return int(m.group(1)), float(m.group(2))


def _gray(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)


def locate_crop(
    image: np.ndarray, crop: np.ndarray
) -> Optional[tuple[int, int, float]]:
    """Find ``crop``'s top-left position in ``image`` by zero-mean normalized
    cross-correlation (FFT-based). Returns (x, y, ncc_peak) or None when the
    crop is larger than the image. JPEG re-encoding noise leaves the NCC peak
    near 1.0 for true matches; crops taken from an *enhanced* (upscaled)
    variant of the image score low and are filtered by the caller."""
    from scipy.signal import fftconvolve

    img = _gray(image) if image.ndim == 3 else image.astype(np.float32)
    tpl = _gray(crop) if crop.ndim == 3 else crop.astype(np.float32)
    th, tw = tpl.shape
    ih, iw = img.shape
    if th > ih or tw > iw or th < 4 or tw < 4:
        return None
    tpl0 = tpl - tpl.mean()
    t_norm = float(np.sqrt((tpl0**2).sum()))
    if t_norm < 1e-3:  # flat crop: position unrecoverable
        return None
    # numerator: cross-correlation with the zero-mean template
    num = fftconvolve(img, tpl0[::-1, ::-1], mode="valid")
    # denominator: local window energy via summed-area tables
    ones = np.ones((th, tw), np.float32)
    s1 = fftconvolve(img, ones, mode="valid")
    s2 = fftconvolve(img**2, ones, mode="valid")
    var = np.maximum(s2 - s1**2 / (th * tw), 0.0)
    std = np.sqrt(var)
    # flat windows (FFT noise makes var ~ 0/negative) cannot be real matches;
    # mask them out or the division explodes to garbage peaks
    ncc = np.where(std > 0.5, num / np.maximum(std * t_norm, 1e-6), -1.0)
    y, x = np.unravel_index(int(np.argmax(ncc)), ncc.shape)
    return int(x), int(y), float(min(ncc[y, x], 1.0))


def _dedupe(faces: list[dict], iou_thr: float = 0.8) -> list[dict]:
    """Merge near-identical boxes (the same face saved by two pipeline runs);
    keeps the conf range so a comparison can accept either run's score."""
    out: list[dict] = []
    for f in faces:
        x1, y1, x2, y2 = f["bbox"]
        merged = False
        for g in out:
            gx1, gy1, gx2, gy2 = g["bbox"]
            ix = max(0, min(x2, gx2) - max(x1, gx1))
            iy = max(0, min(y2, gy2) - max(y1, gy1))
            inter = ix * iy
            union = (x2 - x1) * (y2 - y1) + (gx2 - gx1) * (gy2 - gy1) - inter
            if union > 0 and inter / union >= iou_thr:
                g["conf_lo"] = min(g["conf_lo"], f["conf_lo"])
                g["conf_hi"] = max(g["conf_hi"], f["conf_hi"])
                merged = True
                break
        if not merged:
            out.append(dict(f))
    return out


def extract_image_goldens(
    image_dir: str,
    min_ncc: float = 0.85,
    max_crops: Optional[int] = None,
) -> Optional[dict]:
    """One reference output dir -> {source, image_hw, faces: [...], skipped}."""
    from facedet_tpu_torch.data.native_loader import load_image

    src_path = os.path.join(image_dir, "temp_sahi_input.jpg")
    crops_dir = os.path.join(image_dir, "crops")
    if not (os.path.exists(src_path) and os.path.isdir(crops_dir)):
        return None
    image = load_image(src_path)
    names = sorted(n for n in os.listdir(crops_dir) if parse_crop_name(n))
    if max_crops is not None and len(names) > max_crops:
        return None  # bounded runtime: skip the 500+-crop parade images
    faces, skipped = [], 0
    for name in names:
        idx, conf = parse_crop_name(name)
        try:
            crop = load_image(os.path.join(crops_dir, name))
        except Exception:
            skipped += 1
            continue
        loc = locate_crop(image, crop)
        if loc is None or loc[2] < min_ncc:
            skipped += 1  # e.g. crop cut from an enhanced/upscaled variant
            continue
        x, y, ncc = loc
        faces.append(
            {
                "bbox": [x, y, x + crop.shape[1], y + crop.shape[0]],
                "conf_lo": conf,
                "conf_hi": conf,
                "ncc": round(ncc, 4),
                "face_index": idx,
            }
        )
    return {
        "source": os.path.basename(image_dir),
        "image_hw": [int(image.shape[0]), int(image.shape[1])],
        "faces": _dedupe(faces),
        "skipped_crops": skipped,
    }


def discover_artifact_dirs(ref_dir: str) -> list[str]:
    """Relative paths of reference run-artifact dirs (those holding a
    ``temp_sahi_input.jpg``), walking up to two levels. A dir can be BOTH an
    artifacts dir and a container of them: the reference's temp_streamlit/
    holds a stray top-level temp_sahi_input.jpg next to its per-image
    subdirs, so a hit at level one must not short-circuit the subdir scan
    (dirs without a crops/ folder fall out later via the empty-faces
    filter)."""
    candidates = []
    for name in sorted(os.listdir(ref_dir)):
        d = os.path.join(ref_dir, name)
        if not os.path.isdir(d):
            continue
        if os.path.exists(os.path.join(d, "temp_sahi_input.jpg")):
            candidates.append(name)
        for sub in sorted(os.listdir(d)):
            dd = os.path.join(d, sub)
            if os.path.isdir(dd) and os.path.exists(
                os.path.join(dd, "temp_sahi_input.jpg")
            ):
                candidates.append(f"{name}/{sub}")
    return candidates


def extract_goldens(
    ref_dir: str, min_ncc: float = 0.85, max_crops: Optional[int] = 80
) -> dict:
    """All ``*/temp_sahi_input.jpg`` dirs under a reference root -> goldens.

    Walks up to TWO directory levels so both a single artifacts folder
    (``--ref-dir .../temp_streamlit`` -> bare keys) and the repo root
    (``--ref-dir reference`` -> ``temp_streamlit/<img>`` +
    ``temp_streamlit_batch/<img>`` keys, the committed asset's layout) are
    reproducible. Keys are always relative to ``ref_dir`` — consumers join
    ``ref_dir/<key>/temp_sahi_input.jpg`` (eval/reference_parity.py)."""
    images = {}
    for rel in discover_artifact_dirs(ref_dir):
        g = extract_image_goldens(
            os.path.join(ref_dir, rel), min_ncc=min_ncc, max_crops=max_crops
        )
        if g is not None and g["faces"]:
            images[rel] = g
    return {
        "provenance": "recovered from reference committed run artifacts "
        "(crop filename confidences + NCC-located positions)",
        "min_ncc": min_ncc,
        "images": images,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--min-ncc", type=float, default=0.85)
    ap.add_argument(
        "--max-crops",
        type=int,
        default=80,
        help="skip images with more crops (runtime bound); 0 = no limit",
    )
    args = ap.parse_args(argv)
    goldens = extract_goldens(
        args.ref_dir, min_ncc=args.min_ncc, max_crops=args.max_crops or None
    )
    with open(args.out, "w") as f:
        json.dump(goldens, f, indent=1)
    n = sum(len(g["faces"]) for g in goldens["images"].values())
    print(f"{len(goldens['images'])} images, {n} golden faces -> {args.out}")


if __name__ == "__main__":
    main()
