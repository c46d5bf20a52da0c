"""Real-ESRGAN restoration training: the first-order degradation model, the
patch dataset, the Charbonnier loss, the train step and the staged loop
with an EMA shadow.

Counterpart of facedet_tpu/train/sr_train.py. The host code (``usm_sharpen``,
``degrade_patch``, ``degrade_image``, ``build_sr_dataset``, ``psnr``) is the
JAX module's numpy, PIL and scipy, copied: the same ``default_rng(seed)``
gives the same patches bit for bit. The device side is plain torch ops and
autograd on the port's ``RRDBNet`` (models/rrdbnet.py), which takes and
returns the flax layout (NHWC). The staged loop is a Python loop; its flip
draws are an input, and the EMA decay ``min(ema_decay, (1 + g) / (10 + g))``
at global step ``g`` is computed in float32, as JAX computes it from an
int32 step. The optimizer of the JAX tool (tools/sr_golden_train.py) is
``chain(clip_by_global_norm(5.0), adam(...))``: train/yolo_train.ClippedAdamW
with ``weight_decay=0`` and ``max_norm=5.0``.
"""
from __future__ import annotations

import io
from typing import Optional

import numpy as np
import torch

__all__ = [
    "degrade_patch",
    "degrade_image",
    "usm_sharpen",
    "build_sr_dataset",
    "sr_loss",
    "ema_decay_at",
    "ema_update_",
    "make_sr_train_step",
    "make_sr_staged_loop",
    "psnr",
]


def usm_sharpen(hr_u8: np.ndarray, weight: float = 0.5, radius: float = 2.0, threshold: float = 10.0) -> np.ndarray:
    """Unsharp-mask the HR target (Real-ESRGAN's GT sharpening);
    ``threshold`` (0-255) masks low-contrast residuals so that flat regions
    are not noise-amplified."""
    from scipy.ndimage import gaussian_filter

    img = hr_u8.astype(np.float32)
    residual = img - gaussian_filter(img, (radius, radius, 0.0))
    mask = np.abs(residual) > threshold
    sharp = np.where(mask, img + weight * residual, img)
    return np.clip(sharp.round(), 0, 255).astype(np.uint8)


def degrade_patch(hr_u8: np.ndarray, rng: np.random.Generator, scale: int) -> np.ndarray:
    """One random draw from the first-order practical degradation model:
    gaussian blur -> /scale downsample (random kernel) -> gaussian noise ->
    JPEG re-compression. uint8 HWC in and out; the output is 1/scale the
    size."""
    from PIL import Image
    from scipy.ndimage import gaussian_filter

    img = hr_u8.astype(np.float32)
    if rng.uniform() < 0.9:
        sigma = float(rng.uniform(0.2, 2.2))
        img = gaussian_filter(img, (sigma, sigma, 0.0))
    h, w = img.shape[:2]
    pil = Image.fromarray(np.clip(img.round(), 0, 255).astype(np.uint8))
    interp = [Image.BOX, Image.BILINEAR, Image.BICUBIC][int(rng.integers(3))]
    img = np.asarray(pil.resize((w // scale, h // scale), interp), np.float32)
    if rng.uniform() < 0.8:
        img = img + rng.normal(0.0, float(rng.uniform(1.0, 9.0)), img.shape)
    if rng.uniform() < 0.85:
        q = int(rng.integers(30, 91))
        buf = io.BytesIO()
        Image.fromarray(np.clip(img.round(), 0, 255).astype(np.uint8)).save(buf, "JPEG", quality=q)
        img = np.asarray(Image.open(buf), np.float32)
    return np.clip(img.round(), 0, 255).astype(np.uint8)


def degrade_image(hr_u8: np.ndarray, scale: int, seed: int = 0) -> np.ndarray:
    """Deterministic mid-strength degradation for evaluation: blur sigma
    1.2, bicubic /scale, noise sigma 3, JPEG q40."""
    from PIL import Image
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    img = gaussian_filter(hr_u8.astype(np.float32), (1.2, 1.2, 0.0))
    h, w = img.shape[:2]
    pil = Image.fromarray(np.clip(img.round(), 0, 255).astype(np.uint8))
    img = np.asarray(pil.resize((w // scale, h // scale), Image.BICUBIC), np.float32)
    img = img + rng.normal(0.0, 3.0, img.shape)
    buf = io.BytesIO()
    Image.fromarray(np.clip(img.round(), 0, 255).astype(np.uint8)).save(buf, "JPEG", quality=40)
    return np.asarray(Image.open(buf).convert("RGB"), np.uint8)


def build_sr_dataset(
    images: list[np.ndarray],
    n_patches: int,
    hr_size: int,
    scale: int,
    seed: int = 0,
    face_boxes: Optional[list[np.ndarray]] = None,
    face_fraction: float = 0.5,
    usm_weight: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Sample ``n_patches`` HR crops from ``images`` (uint8 HWC, any sizes)
    and degrade each independently. With ``face_boxes`` (xyxy per image),
    ``face_fraction`` of the patches centre on a random face.
    ``usm_weight > 0`` sharpens the HR targets (LR is always degraded from
    the unsharpened crop). Returns (lr_u8 [N,hr/scale,hr/scale,3],
    hr_u8 [N,hr,hr,3])."""
    rng = np.random.default_rng(seed)
    usable = [i for i, im in enumerate(images) if im.shape[0] >= hr_size and im.shape[1] >= hr_size]
    if not usable:
        raise ValueError(f"no image is >= {hr_size}px on both sides")
    lr_all = np.empty((n_patches, hr_size // scale, hr_size // scale, 3), np.uint8)
    hr_all = np.empty((n_patches, hr_size, hr_size, 3), np.uint8)
    for n in range(n_patches):
        i = usable[int(rng.integers(len(usable)))]
        img = images[i]
        h, w = img.shape[:2]
        boxes = face_boxes[i] if face_boxes is not None else None
        if boxes is not None and len(boxes) and rng.uniform() < face_fraction:
            b = boxes[int(rng.integers(len(boxes)))]
            cx = int((b[0] + b[2]) / 2 + rng.normal(0, hr_size / 8))
            cy = int((b[1] + b[3]) / 2 + rng.normal(0, hr_size / 8))
            y0 = int(np.clip(cy - hr_size // 2, 0, h - hr_size))
            x0 = int(np.clip(cx - hr_size // 2, 0, w - hr_size))
        else:
            y0 = int(rng.integers(0, h - hr_size + 1))
            x0 = int(rng.integers(0, w - hr_size + 1))
        hr = img[y0 : y0 + hr_size, x0 : x0 + hr_size]
        hr_all[n] = usm_sharpen(hr, weight=usm_weight) if usm_weight > 0 else hr
        lr_all[n] = degrade_patch(hr, rng, scale)
    return lr_all, hr_all


def sr_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Charbonnier (smooth L1) in [0, 1] space, Real-ESRGAN's pixel loss."""
    return torch.sqrt((pred - target) ** 2 + eps**2).mean()


def ema_decay_at(g: int, ema_decay: float) -> tuple[float, float]:
    """(d, 1 - d) of the EMA at global step ``g``: ``min(ema_decay, (1 + g)
    / (10 + g))`` in float32, as JAX computes it from an int32 step."""
    gf = np.float32(g)
    d = np.minimum(np.float32(ema_decay), (np.float32(1.0) + gf) / (np.float32(10.0) + gf))
    return float(d), float(np.float32(1.0) - d)


def ema_update_(ema: torch.nn.Module, model: torch.nn.Module, g: int, ema_decay: float) -> None:
    """``e = e * d + p * (1 - d)`` over the floating-point state of ``ema``
    and ``model`` (same structure), in place."""
    d, one_minus = ema_decay_at(g, ema_decay)
    with torch.no_grad():
        shadow = [t for t in ema.state_dict().values() if t.is_floating_point()]
        live = [t for t in model.state_dict().values() if t.is_floating_point()]
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, torch._foreach_mul(live, one_minus))


def make_sr_train_step(model, tx):
    """``step(lr [B,h,w,3] float in [0,1], hr [B,H,W,3]) -> loss``: forward,
    ``sr_loss``, ``backward``, ``tx.step()`` (any object with ``zero_grad``
    and ``step``). The loss stays on the device."""

    def step(lr, hr):
        tx.zero_grad()
        loss = sr_loss(model(lr), hr)
        loss.backward()
        tx.step()
        return loss.detach()

    return step


def _staged_pair(lr_u8, hr_u8, idx: int, flips: Optional[torch.Tensor]):
    """Batch ``idx`` of the staged uint8 pairs in [0, 1] (XLA's ``x / 255``),
    each pair mirrored along W where ``flips`` [B] says so."""
    lr = lr_u8[idx].float() * (1.0 / 255.0)
    hr = hr_u8[idx].float() * (1.0 / 255.0)
    if flips is not None:
        f = flips[:, None, None, None]
        lr = torch.where(f, lr.flip(2), lr)
        hr = torch.where(f, hr.flip(2), hr)
    return lr, hr


def _flip_draws(flip: bool, flips, steps: int, b: int, gen: torch.Generator, device):
    if not flip:
        return None
    if flips is None:
        flips = torch.rand((steps, b), generator=gen) < 0.5
    return torch.as_tensor(flips, dtype=torch.bool).to(device)


def make_sr_staged_loop(model, tx, steps_per_dispatch: int = 50, flip: bool = True, ema_decay: float = 0.999,
                        seed: int = 0):
    """Training over staged uint8 pairs ``lr_u8 [N,B,h,w,3]`` / ``hr_u8
    [N,B,H,W,3]`` on the device with an EMA shadow of the weights.

    ``run(ema, lr_u8, hr_u8, start=0, flips=None) -> mean loss``: ``ema`` is
    a module of the model's structure (a copy made at the start), updated in
    place; ``start`` is the global step count already taken (batches are
    consumed round-robin from it, and it drives the EMA warmup); ``flips``
    [steps, B] gives the paired flip draws (JAX's ``bernoulli(fold_in(key,
    i))``), by default from a generator seeded with ``seed``. With
    ``flip=False`` each step is ``make_sr_train_step``'s on the same
    batch."""
    step = make_sr_train_step(model, tx)
    gen = torch.Generator().manual_seed(seed)

    def run(ema, lr_u8, hr_u8, start: int = 0, flips=None):
        n, b = lr_u8.shape[:2]
        flips = _flip_draws(flip, flips, steps_per_dispatch, b, gen, lr_u8.device)
        loss_sum = torch.zeros((), device=lr_u8.device)
        for i in range(steps_per_dispatch):
            g = start + i
            lr, hr = _staged_pair(lr_u8, hr_u8, g % n, None if flips is None else flips[i])
            loss_sum = loss_sum + step(lr, hr)
            ema_update_(ema, model, g, ema_decay)
        return loss_sum / steps_per_dispatch

    return run


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio between two uint8/float arrays."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(peak**2 / mse))
