"""Checkpoint conversion: torch state dicts of the published projects ->
state dicts of the port's modules.

Counterpart of facedet_tpu/models/convert.py. Real-ESRGAN ``.pth`` files
(basicsr's ``RRDBNet``) and ultralytics yolo11(-pose) ``.pt`` files name
their tensors after their own module trees; this module maps those names
onto the port's (which carry the flax names, models/layers.py), with a
strict check of every key and shape: a tensor the port's module needs and
the checkpoint lacks raises ``KeyError``, a shape that differs raises
``ValueError``, as in the JAX package. Both sides are OIHW, so kernels are
carried across untransposed.

Two differences from the JAX route, both on purpose:

- The target names come from the port's module built from ``cfg`` (on the
  ``meta`` device: no memory, no init), so every parameter and statistic
  must be found; the JAX route fills what its walk finds and keeps the
  init elsewhere.
- basicsr's x2 and x1 nets pixel-unshuffle their input in the order
  ``c*f*f + fy*f + fx`` (``F.pixel_unshuffle``), the port's and the flax
  net's in the order ``(fy*f + fx)*C + c`` (models/rrdbnet.py). The JAX
  route carries ``conv_first`` unpermuted, so its x2plus reads the wrong
  input planes; here ``conv_first``'s input channels are permuted into the
  port's order. At scale 4 nothing is unshuffled and the two routes agree.

Loading the result goes through the module's own ``load_state_dict``
(``from_jax._load_strict``, which also sets the BatchNorm step counters).
An ultralytics ``.pt`` that pickles ultralytics classes needs that package
to unpickle; export its ``model.state_dict()`` with ``torch.save`` and pass
that file, or pass the state dict itself.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "convert_rrdbnet_checkpoint",
    "convert_ultralytics_checkpoint",
    "detect_yolo_scale",
]

# yolo11(-pose) yaml module index -> the port's module path
_YOLO_INDEX = {
    "backbone.stem": 0,
    "backbone.down1": 1,
    "backbone.c3k2_0": 2,
    "backbone.down2": 3,
    "backbone.c3k2_1": 4,
    "backbone.down3": 5,
    "backbone.c3k2_2": 6,
    "backbone.down4": 7,
    "backbone.c3k2_3": 8,
    "backbone.sppf": 9,
    "backbone.c2psa": 10,
    "neck.up0": 13,
    "neck.up1": 16,
    "neck.down0": 17,
    "neck.pan0": 19,
    "neck.down1": 20,
    "neck.pan1": 22,
}
# the class branch's depthwise-separable stages -> ultralytics cv3.{i}.<stage>
_CLS_STAGES = {"dw0": "0.0", "pw0": "0.1", "dw1": "1.0", "pw1": "1.1", "out": "2"}
_HEAD_BRANCHES = {"box": "cv2", "kpt": "cv4"}


def _load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """A ``.pt`` / ``.pth`` file -> {name: float32 array}, unwrapping
    basicsr's ``params_ema`` / ``params``, a pickled ``model`` or a
    ``state_dict`` entry, as the JAX package does."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "params_ema" in obj:
        obj = obj["params_ema"]
    elif isinstance(obj, dict) and "params" in obj:
        obj = obj["params"]
    elif isinstance(obj, dict) and "model" in obj and hasattr(obj["model"], "state_dict"):
        obj = obj["model"].state_dict()
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v.detach().float().cpu().numpy() for k, v in obj.items()}


def _state_dict(path_or_sd) -> dict[str, np.ndarray]:
    if not isinstance(path_or_sd, dict):
        return _load_torch_state_dict(path_or_sd)
    return {
        k: v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
        for k, v in path_or_sd.items()
    }


def _fill(target: dict[str, torch.Tensor], sd: dict[str, np.ndarray], source_name) -> dict[str, torch.Tensor]:
    """{target key: tensor} read from ``sd`` under ``source_name(key)``;
    BatchNorm step counters are left to the loader."""
    state = {}
    for key, want in target.items():
        if key.endswith("num_batches_tracked"):
            continue
        src = source_name(key)
        if src not in sd:
            raise KeyError(f"the checkpoint has no {src} (for {key})")
        arr = sd[src]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {key}: module {tuple(want.shape)} vs checkpoint {src} {tuple(arr.shape)}")
        state[key] = torch.from_numpy(np.array(arr, np.float32))
    return state


# ---------------------------------------------------------------- RRDBNet ---


def _unshuffle_permutation(channels: int, factor: int) -> np.ndarray:
    """``perm`` with ``port[:, q*C + c] = basicsr[:, perm[q*C + c]]``: the
    port's input plane ``(fy*f + fx)*C + c`` is basicsr's ``c*f*f + fy*f + fx``."""
    q, c = np.divmod(np.arange(channels * factor * factor), channels)
    return c * factor * factor + q


def convert_rrdbnet_checkpoint(path_or_sd, cfg) -> dict[str, torch.Tensor]:
    """Real-ESRGAN ``.pth`` (or its state dict) -> the state dict of the
    port's ``RRDBNet(cfg)``. basicsr naming: ``conv_first``,
    ``body.{i}.rdb{j}.conv{k}``, ``conv_body``, ``conv_up1``, ``conv_up2``,
    ``conv_hr``, ``conv_last``, each a conv with bias."""
    from facedet_tpu_torch.models.rrdbnet import RRDBNet

    sd = _state_dict(path_or_sd)
    with torch.device("meta"):
        target = RRDBNet(cfg).state_dict()

    def source_name(key: str) -> str:
        head, _, rest = key.partition(".")
        return f"body.{head[4:]}.{rest}" if head.startswith("body") else key

    state = _fill(target, sd, source_name)
    factor = {2: 2, 1: 4}.get(cfg.scale, 1)
    if factor > 1:
        state["conv_first.weight"] = state["conv_first.weight"][:, _unshuffle_permutation(cfg.num_in_ch, factor)]
    return state


# ---------------------------------------------------------------- YOLOv11 ---


def _inner_name(parts: list[str]) -> str:
    """The port's names inside a block -> ultralytics': ``m{i}`` ->
    ``m.{i}``, ``ffn0`` / ``ffn1`` -> ``ffn.0`` / ``ffn.1``."""
    toks = []
    for p in parts:
        if p in ("ffn0", "ffn1"):
            toks.append(f"ffn.{p[3]}")
        elif p[0] == "m" and p[1:].isdigit():
            toks.append(f"m.{p[1:]}")
        else:
            toks.append(p)
    return ".".join(toks)


def _ultralytics_name(key: str, head_idx: int) -> str:
    """The port's key -> the ultralytics state-dict key."""
    parts = key.split(".")
    if parts[0] == "head":
        name, rest = parts[1], parts[2:]
        kind, level, stage = name[:3], name[3], name[5:]
        if kind == "cls":
            base = f"model.{head_idx}.cv3.{level}.{_CLS_STAGES[stage]}"
        else:
            base = f"model.{head_idx}.{_HEAD_BRANCHES[kind]}.{level}.{stage}"
    else:
        base = f"model.{_YOLO_INDEX['.'.join(parts[:2])]}"
        rest = parts[2:]
    return f"{base}.{_inner_name(rest)}"


def detect_yolo_scale(sd: dict) -> str | None:
    """The yolo11 scale whose widths and depths the state dict has: the
    stem's output channels and the first C3k2's block count; None if no
    published scale has them."""
    from facedet_tpu_torch.models.yolov11 import SCALES, YoloConfig

    width = sd["model.0.conv.weight"].shape[0]
    depth = 0
    while f"model.2.m.{depth}.cv1.conv.weight" in sd:
        depth += 1
    for scale in SCALES:
        cfg = YoloConfig(scale=scale)
        if cfg.ch(64) == width and cfg.depth(2) == depth:
            return scale
    return None


def convert_ultralytics_checkpoint(path_or_sd, cfg) -> tuple[dict[str, torch.Tensor], str]:
    """ultralytics yolo11(-pose) ``.pt`` (or its ``model.N.*`` state dict)
    -> (the state dict of the port's ``YoloV11(cfg)``, the scale). The scale
    is read from the checkpoint's widths; one other than ``cfg.scale``
    raises ``ValueError``."""
    from facedet_tpu_torch.models.yolov11 import YoloV11

    sd = _state_dict(path_or_sd)
    # "model.model.N" (a pickled DetectionModel's own dict) -> "model.N"
    sd = {k[6:] if k.startswith("model.model.") else k: v for k, v in sd.items()}
    scale = detect_yolo_scale(sd)
    if scale is not None and scale != cfg.scale:
        raise ValueError(f"the checkpoint is a yolo11{scale}, the config asks for yolo11{cfg.scale}")
    head_idx = next((i for i in (23, 22, 21) if f"model.{i}.cv2.0.0.conv.weight" in sd), None)
    if head_idx is None:
        raise KeyError("could not locate the detect head (model.N.cv2.0.0.conv.weight)")
    with torch.device("meta"):
        target = YoloV11(cfg).state_dict()
    return _fill(target, sd, lambda key: _ultralytics_name(key, head_idx)), cfg.scale
