"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout, at first
use; the hash covers the source and the flags, so an edited source rebuilds.
All sources compile in parallel, one ``nvcc`` each. The libraries have a plain
C interface and load with ``ctypes``. This module is imported only by the CUDA
branch of a kernel wrapper: hosts without ``nvcc`` never import it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# C signatures: pointers and the stream are c_void_p, ints c_int, and every
# function returns the cudaError_t of its launch.
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "tile_gather": {
        "facedet_tile_gather_hwc": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "facedet_tile_gather_chw": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "facedet_tile_gather_chw_batched": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this host")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every stale source (all ``nvcc`` processes started together),
    then load every library. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SIGNATURES:
        target = _target(name)
        if name in _LIBS or target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp,
            target,
            time.perf_counter(),
        )
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    for name in SIGNATURES:
        load(name)
    return dict(_LIBS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    target = _target(name)
    if not target.exists():
        build_all()
        return _LIBS[name]
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _LIBS[name] = lib
    return lib
