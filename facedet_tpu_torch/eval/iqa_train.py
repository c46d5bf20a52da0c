"""Offline calibration of the IQA metrics: freeze the NIQE pristine model and
train the BRISQUE SVR scoring stage.

Run ``python -m facedet_tpu.eval.iqa_train`` to (re)generate the committed
artifacts in ``facedet_tpu/eval/assets/``:

  * ``niqe_pristine.npz`` — {mu [36], cov [36,36]} multivariate-Gaussian
    pristine model (the stand-in for the official niqe_image_params.mat,
    whose corpus is not redistributable). Frozen so absolute NIQE values are
    stable across runs and releases.
  * ``brisque_svr.npz`` — an RBF kernel-ridge regressor (the numpy-only
    equivalent of BRISQUE's LIVE-trained SVR) mapping 36-dim BRISQUE features
    to a 0-100 quality score. Trained on a synthetic distortion bank (blur /
    noise / JPEG / rescale at graded severities) with monotone targets, so
    scores behave like published BRISQUE (pristine low, distorted high) even
    though absolute calibration differs from the LIVE-DMOS fit (the delta
    against pyiqa is not measured; documented in eval/iqa.py).

Reference: pipeline_v4_yolo/1_Inference.py:121-183 (pyiqa NIQE+BRISQUE),
BASELINE.md IQA table.

Counterpart of facedet_tpu/eval/iqa_train.py: the distortion bank, the
regressor and ``svr_predict`` are a numpy copy. ``real_photo_corpus`` and
``main`` regenerate the committed artifacts from the golden photographs
through the JAX package's tools/sr_golden_train.py, which is not ported yet:
they raise.
"""
from __future__ import annotations

import io

import numpy as np

from facedet_tpu_torch.eval.iqa import (
    _filter2,
    _gaussian_kernel,
    _synthetic_pristine_images,
    brisque_features,
)


# ------------------------------------------------------------- distortions -

def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    size = max(3, int(sigma * 4) | 1)
    return _filter2(img, _gaussian_kernel(size, sigma))


def _noise(img: np.ndarray, std: float, rng) -> np.ndarray:
    return np.clip(img + rng.standard_normal(img.shape) * std, 0, 255)


def _jpeg(img: np.ndarray, quality: int) -> np.ndarray:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8), "L").save(buf, "JPEG", quality=quality)
    return np.asarray(Image.open(buf), np.float64)


def _rescale(img: np.ndarray, factor: int) -> np.ndarray:
    small = img[::factor, ::factor]
    return np.kron(small, np.ones((factor, factor)))[: img.shape[0], : img.shape[1]]


def build_distortion_bank(n_pristine: int = 8, size: int = 256, seed: int = 7):
    """(features [N,36], targets [N]) over pristine + graded distortions.

    Targets follow the BRISQUE convention (0 = pristine, ~100 = destroyed),
    monotone in severity within each distortion family."""
    rng = np.random.default_rng(seed)
    pristine = _synthetic_pristine_images(n=n_pristine, size=size, seed=seed)
    feats, targets = [], []
    for img in pristine:
        feats.append(brisque_features(img))
        targets.append(5.0)
        for level, (sigma, std, q, f) in enumerate(
            [(1.0, 8.0, 60, 2), (2.0, 18.0, 30, 4), (4.0, 32.0, 12, 8), (7.0, 55.0, 5, 16)]
        ):
            t = 25.0 + 20.0 * level  # 25 / 45 / 65 / 85
            feats.append(brisque_features(_blur(img, sigma)))
            targets.append(t)
            feats.append(brisque_features(_noise(img, std, rng)))
            targets.append(t)
            feats.append(brisque_features(_jpeg(img, q)))
            targets.append(t)
            feats.append(brisque_features(_rescale(img, f)))
            targets.append(t)
    return np.asarray(feats), np.asarray(targets)


# -------------------------------------------------------------- SVR (KRR) -

def train_brisque_svr(
    feats: np.ndarray, targets: np.ndarray, gamma: float | None = None, lam: float = 1e-3
) -> dict:
    """RBF kernel ridge regression (closed form — the numpy-only stand-in for
    libsvm's epsilon-SVR used by official BRISQUE). Returns the frozen
    regressor: support vectors (all training points), dual coefs, kernel
    width, and the feature standardiser."""
    mu = feats.mean(0)
    sd = feats.std(0) + 1e-9
    x = (feats - mu) / sd
    if gamma is None:
        # median heuristic
        d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
        gamma = 1.0 / (np.median(d2[d2 > 0]) + 1e-12)
    k = np.exp(-gamma * ((x[:, None] - x[None]) ** 2).sum(-1))
    alpha = np.linalg.solve(k + lam * np.eye(len(x)), targets)
    return {
        "sv": x,
        "alpha": alpha,
        "gamma": np.float64(gamma),
        "feat_mu": mu,
        "feat_sd": sd,
    }


def svr_predict(model: dict, feats: np.ndarray) -> np.ndarray:
    x = (np.atleast_2d(feats) - model["feat_mu"]) / model["feat_sd"]
    d2 = ((x[:, None] - model["sv"][None]) ** 2).sum(-1)
    return np.exp(-float(model["gamma"]) * d2) @ model["alpha"]


def real_photo_corpus(max_images: int = 20) -> list[np.ndarray]:
    """The golden WIDERFACE scenes, the pristine corpus for NIQE: they load
    through tools/sr_golden_train.py, which is not ported yet."""
    raise NotImplementedError("real_photo_corpus is not yet ported (it needs tools/sr_golden_train.py)")


def main() -> dict:
    """Regenerates ``niqe_pristine.npz`` and ``brisque_svr.npz`` from the
    golden photographs: not yet ported (the JAX package's
    ``python -m facedet_tpu.eval.iqa_train`` writes them)."""
    raise NotImplementedError("regenerating the IQA artifacts is not yet ported")
