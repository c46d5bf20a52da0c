"""Native parallel image loader.

Counterpart of facedet_tpu/data/native_loader.py: its own ctypes wrapper over
the libjpeg-backed C++ decoder ``native/jpeg_decoder.cpp``, built with
``g++ ... -ljpeg`` into ``build/native/`` at first use. The decodes release
the GIL, so a small thread pool prefetches an image stream in parallel with
the device. Non-JPEG files, JPEGs the raw paths refuse (not 4:2:0, stored AC
outside int8) and hosts without libjpeg's headers take PIL per file.
"""
from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np

from facedet_tpu_torch.ops.color import rgb_to_yuv420
from facedet_tpu_torch.ops.jpeg_dct import DctImage, encode_dct420
from facedet_tpu_torch.utils.native import load_native

__all__ = [
    "load_image",
    "load_image_native",
    "load_image_yuv420",
    "load_image_dct420",
    "decode_jpeg_bytes_dct420",
    "save_dct420_jpeg",
    "prefetch_images",
]

_P = ctypes.POINTER
_DCT_PLANES = [_P(ctypes.c_short), _P(ctypes.c_byte), _P(ctypes.c_short), _P(ctypes.c_byte),
               _P(ctypes.c_ushort), _P(ctypes.c_ushort)]
_WIDE_PLANES = [_P(ctypes.c_short)] * 4 + [_P(ctypes.c_ushort)] * 2
_SIGNATURES = {
    "jpeg_dims": [ctypes.c_char_p] + [_P(ctypes.c_int)] * 3,
    "jpeg_decode_rgb": [ctypes.c_char_p, _P(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int],
    "jpeg_decode_yuv420": [ctypes.c_char_p] + [_P(ctypes.c_ubyte)] * 3 + [ctypes.c_int] * 2,
    "jpeg_read_dct420": [ctypes.c_char_p] + _DCT_PLANES + [ctypes.c_int] * 2,
    "jpeg_dims_mem": [ctypes.c_char_p, ctypes.c_long] + [_P(ctypes.c_int)] * 3,
    "jpeg_read_dct420_mem": [ctypes.c_char_p, ctypes.c_long] + _DCT_PLANES + [ctypes.c_int] * 2,
    "jpeg_write_dct420": [ctypes.c_char_p] + _DCT_PLANES + [ctypes.c_int] * 4,
    "jpeg_write_dct420_wide": [ctypes.c_char_p] + _WIDE_PLANES + [ctypes.c_int] * 4,
}


def _load_native():
    """The decoder's library with its signatures set, or None (no ``g++``,
    no libjpeg headers): every loader then takes its PIL path."""
    lib = load_native("jpeg_decoder", flags=("-O2",), libs=("-ljpeg",))
    if lib is not None and lib.jpeg_dims.argtypes is None:
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def load_image_native(path: str) -> Optional[np.ndarray]:
    """Decode one JPEG via the native library; None if it cannot."""
    lib = _load_native()
    if lib is None or not path.lower().endswith((".jpg", ".jpeg")):
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    if lib.jpeg_dims(path.encode(), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.jpeg_decode_rgb(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h.value, w.value
    )
    return out if rc == 0 else None


def load_image_yuv420(path: str):
    """Decode a JPEG straight to (Y [H,W], UV [ceil(H/2),ceil(W/2),2]) uint8
    planes via libjpeg's raw-data path (no chroma upsample, no RGB convert) —
    the zero-copy source for the engine's ``input_format="yuv420"`` ingest.
    Falls back to RGB decode + host subsample for non-4:2:0 files; returns
    None when the image cannot be decoded at all."""
    lib = _load_native()
    if lib is not None and path.lower().endswith((".jpg", ".jpeg")):
        h = ctypes.c_int()
        w = ctypes.c_int()
        c = ctypes.c_int()
        if (
            lib.jpeg_dims(path.encode(), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
            == 0
        ):
            ph = -(-h.value // 16) * 16
            pw = -(-w.value // 16) * 16
            y = np.empty((ph, pw), np.uint8)
            cb = np.empty((ph // 2, pw // 2), np.uint8)
            cr = np.empty((ph // 2, pw // 2), np.uint8)
            p = ctypes.POINTER(ctypes.c_ubyte)
            rc = lib.jpeg_decode_yuv420(
                path.encode(),
                y.ctypes.data_as(p),
                cb.ctypes.data_as(p),
                cr.ctypes.data_as(p),
                ph,
                pw,
            )
            if rc == 0:
                hh, ww = -(-h.value // 2), -(-w.value // 2)
                uv = np.stack([cb[:hh, :ww], cr[:hh, :ww]], axis=-1)
                return y[: h.value, : w.value], uv
    try:
        rgb = load_image(path)
    except Exception:
        return None
    return rgb_to_yuv420(rgb)


def _native_read_dct420(lib, h: int, w: int, call):
    """Allocate DctImage-layout buffers for an (h, w) image and run ``call``
    (the file or memory native reader) against their pointers; returns the
    DctImage or None if the native read declined (non-4:2:0, AC overflow)."""
    ph = -(-h // 16) * 16
    pw = -(-w // 16) * 16
    yb_h, yb_w = ph // 8, pw // 8
    y_dc = np.zeros((yb_h, yb_w), np.int16)
    y_ac = np.zeros((yb_h, yb_w, 64), np.int8)
    uv_dc = np.zeros((yb_h // 2, yb_w // 2, 2), np.int16)
    uv_ac = np.zeros((yb_h // 2, yb_w // 2, 2, 64), np.int8)
    qy = np.zeros(64, np.uint16)
    qc = np.zeros(64, np.uint16)
    rc = call(
        y_dc.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
        y_ac.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
        uv_dc.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
        uv_ac.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
        qy.ctypes.data_as(ctypes.POINTER(ctypes.c_ushort)),
        qc.ctypes.data_as(ctypes.POINTER(ctypes.c_ushort)),
        yb_h,
        yb_w,
    )
    if rc != 0:
        return None
    return DctImage(
        y_dc=y_dc,
        y_ac=y_ac,
        uv_dc=uv_dc,
        uv_ac=uv_ac,
        qy=qy.astype(np.float32),
        qc=qc.astype(np.float32),
        hw=(h, w),
    )


def load_image_dct420(path: str):
    """JPEG file -> :class:`~facedet_tpu_torch.ops.jpeg_dct.DctImage` holding the
    file's *stored* quantized coefficients (native jpeg_read_coefficients —
    no IDCT anywhere on the host), the lossless source for the engine's
    ``input_format="dct420"`` ingest. Non-4:2:0 files (or stored AC outside
    the int8 wire range) fall back to RGB decode + ``encode_dct420`` at
    quality 90; returns None when the image cannot be decoded at all."""
    lib = _load_native()
    if lib is not None and path.lower().endswith((".jpg", ".jpeg")):
        h = ctypes.c_int()
        w = ctypes.c_int()
        c = ctypes.c_int()
        if (
            lib.jpeg_dims(path.encode(), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
            == 0
        ):
            d = _native_read_dct420(
                lib, h.value, w.value,
                lambda *ptrs: lib.jpeg_read_dct420(path.encode(), *ptrs),
            )
            if d is not None:
                return d
    try:
        rgb = load_image(path)
    except Exception:
        return None
    return encode_dct420(rgb)


def decode_jpeg_bytes_dct420(data: bytes):
    """In-memory JPEG (e.g. one MJPEG-AVI frame, data/video.py) -> DctImage
    of its stored coefficients via the native jpeg_mem_src reader; same
    fallback contract as :func:`load_image_dct420`. Returns None only when
    the bytes are not decodable as a JPEG at all."""
    lib = _load_native()
    if lib is not None:
        h = ctypes.c_int()
        w = ctypes.c_int()
        c = ctypes.c_int()
        if (
            lib.jpeg_dims_mem(
                data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)
            )
            == 0
        ):
            d = _native_read_dct420(
                lib, h.value, w.value,
                lambda *ptrs: lib.jpeg_read_dct420_mem(data, len(data), *ptrs),
            )
            if d is not None:
                return d
    import io

    try:
        from PIL import Image

        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None
    return encode_dct420(rgb)


def save_dct420_jpeg(path: str, img) -> bool:
    """Entropy-code a :class:`~facedet_tpu_torch.ops.jpeg_dct.DctImage` into a
    real baseline JPEG (native jpeg_write_coefficients, the mirror of
    :func:`load_image_dct420`; no DCT runs on the host in either direction).
    Coefficients encoded on the device land on disk this way without ever
    becoming host pixels. Returns False when the native library is
    unavailable (the caller then decodes to pixels and saves with PIL)."""
    lib = _load_native()
    if lib is None:
        return False
    h, w = img.hw
    # planes may live on a bucketed canvas larger than the image; the file's
    # block dims are fixed by (h, w), so slice
    yb_h = -(-h // 16) * 2
    yb_w = -(-w // 16) * 2
    # wide (int16) AC wire when the planes carry it — the fetch path for
    # high-contrast SR outputs whose quantized AC exceeds int8 (the device
    # encoder clips at JPEG baseline's 1023 Huffman ceiling instead)
    wide = img.y_ac.dtype == np.int16
    ac_dtype = np.int16 if wide else np.int8
    ac_ptr = ctypes.c_short if wide else ctypes.c_byte
    writer = lib.jpeg_write_dct420_wide if wide else lib.jpeg_write_dct420
    y_dc = np.ascontiguousarray(img.y_dc[:yb_h, :yb_w], np.int16)
    y_ac = np.ascontiguousarray(img.y_ac[:yb_h, :yb_w], ac_dtype)
    uv_dc = np.ascontiguousarray(img.uv_dc[: yb_h // 2, : yb_w // 2], np.int16)
    uv_ac = np.ascontiguousarray(img.uv_ac[: yb_h // 2, : yb_w // 2], ac_dtype)
    qy = np.ascontiguousarray(np.rint(img.qy), np.uint16)
    qc = np.ascontiguousarray(np.rint(img.qc), np.uint16)
    rc = writer(
        path.encode(),
        y_dc.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
        y_ac.ctypes.data_as(ctypes.POINTER(ac_ptr)),
        uv_dc.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
        uv_ac.ctypes.data_as(ctypes.POINTER(ac_ptr)),
        qy.ctypes.data_as(ctypes.POINTER(ctypes.c_ushort)),
        qc.ctypes.data_as(ctypes.POINTER(ctypes.c_ushort)),
        yb_h,
        yb_w,
        h,
        w,
    )
    return rc == 0


def load_image(path: str) -> np.ndarray:
    """Native decode with PIL fallback."""
    img = load_image_native(path)
    if img is not None:
        return img
    from facedet_tpu_torch.utils.viz import load_image as pil_load

    return pil_load(path)


def prefetch_images(
    paths: Iterable[str], num_workers: int = 4, window: int = 8, loader=None
) -> Iterator[tuple[str, Optional[np.ndarray]]]:
    """Ordered prefetching iterator: decodes up to ``window`` images ahead on a
    thread pool (GIL released inside the native decode). ``loader`` swaps the
    per-path decode (default RGB ``load_image``; pass ``load_image_dct420`` /
    ``load_image_yuv420`` for the low-bandwidth ingest formats)."""
    from collections import deque

    if loader is None:
        loader = load_image

    def safe(path):
        try:
            return loader(path)
        except Exception:
            return None

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending: deque = deque()
        for path in paths:
            pending.append((path, pool.submit(safe, path)))
            if len(pending) >= window:
                p, fut = pending.popleft()
                yield p, fut.result()
        while pending:
            p, fut = pending.popleft()
            yield p, fut.result()
