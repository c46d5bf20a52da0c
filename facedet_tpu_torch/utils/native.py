"""Build and load the framework-independent C++ helpers of ``native/``.

``native/<name>.cpp`` compiles with ``g++`` into ``build/native/lib<name>.so``
at the root of the checkout at first use, and again when the source is newer
than the library. The sources are shared with the JAX package, which keeps
its own libraries beside them; this package only reads them.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"

_lock = threading.Lock()
_libs: dict[str, Optional[ctypes.CDLL]] = {}


def load_native(name: str, flags: Sequence[str] = (), libs: Sequence[str] = ()) -> Optional[ctypes.CDLL]:
    """The library of ``native/<name>.cpp``, or None when it cannot be built
    or loaded on this host (no ``g++``, a missing system header or library,
    named in ``libs`` as linker flags): callers
    then take their numpy or PIL path. The outcome is cached per process."""
    if name in _libs:
        return _libs[name]
    with _lock:
        if name in _libs:
            return _libs[name]
        src = NATIVE_DIR / f"{name}.cpp"
        so = BUILD_DIR / f"lib{name}.so"
        lib = None
        try:
            if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", "-shared", "-fPIC", *flags, str(src), "-o", str(tmp), *libs],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so)  # atomic: another process never loads half a file
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError):
            lib = None
        _libs[name] = lib
    return lib
