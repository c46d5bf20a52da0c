"""A configuration's weights, as its family resolves them. ``"weights"`` is
either the path of a flax ``.npz`` (flat ``a/b/c`` keys) under the
repository, read as data, or ``{"seed": N}``: float32 arrays that the
family's ``draw(N)`` makes. The program loads either through its public
loader, from a file: drawn arrays are written once to
``build/port_bench_weights/<digest>.npz`` in the checkout (a fixed path, so
later runs find it). The reference takes the same arrays (``arrays``).
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch


def seeded(spec) -> bool:
    return isinstance(spec, dict)


def arrays(spec, root: str, draw=None) -> dict[str, np.ndarray]:
    """{key: array} of the ``.npz`` at ``spec``, or ``draw(seed)`` in
    float32."""
    if seeded(spec):
        return {k: np.ascontiguousarray(v, np.float32) for k, v in draw(int(spec["seed"])).items()}
    with np.load(os.path.join(root, spec)) as flat:
        return {k: flat[k] for k in flat.files}


def path(spec, root: str, draw=None) -> str:
    """The ``.npz`` the program loads: the configuration's own, or the
    drawn arrays written under ``build/`` if they are not there yet."""
    if not seeded(spec):
        return os.path.join(root, spec)
    drawn = arrays(spec, root, draw)
    digest = hashlib.sha256()
    for k in sorted(drawn):
        digest.update(f"{k}{drawn[k].shape}".encode())
        digest.update(drawn[k].tobytes())
    out = os.path.join(root, "build", "port_bench_weights", f"{digest.hexdigest()[:32]}.npz")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.part"
        with open(tmp, "wb") as f:
            np.savez(f, **drawn)
        os.replace(tmp, out)
    return out


def tensors(flat: dict[str, np.ndarray], device) -> dict:
    """{key: float32 tensor on ``device``}, conv kernels HWIO turned OIHW:
    the reference's form of a flax checkpoint."""
    out = {}
    for key, a in flat.items():
        a = a.astype(np.float32)
        if key.endswith("kernel") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def load_npz(path: str, device) -> dict:
    """The reference's tensors of the ``.npz`` at ``path``."""
    return tensors(arrays(path, ""), device)
