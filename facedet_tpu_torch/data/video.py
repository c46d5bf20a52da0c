"""Video IO without OpenCV: MJPEG-AVI and Y4M in numpy / struct / PIL, and
an ffmpeg subprocess for other codecs where the binary exists.

Counterpart of facedet_tpu/data/video.py, copied (it holds no JAX): the
same RIFF walker, MJPEG AVI reader and writer (``MjpegAviWriter`` spools
frames to ``<path>.movi.tmp`` and writes the headers on close), Y4M reader
with its ``yuv420`` plane passthrough, and the ffmpeg / ffprobe routes, so
both packages write byte-identical AVI files from the same frames.
``ingest="dct420"`` yields each MJPEG frame's stored JPEG coefficients
through the port's ``native_loader.decode_jpeg_bytes_dct420``.

  * MJPEG AVI — a RIFF container whose frames are plain JPEGs; demuxing is
    chunk walking and decoding rides the existing JPEG path. Also the WRITER
    format for annotated output videos (every player opens MJPEG AVI).
  * Y4M (YUV4MPEG2) — headers + raw 4:2:0 planes; numpy converts to RGB.

Anything else (.mp4/H.264 etc.) is piped through ``ffmpeg -f rawvideo`` when
an ffmpeg binary is on PATH, with a clear error otherwise.
"""
from __future__ import annotations

import io
import os
import shutil
import struct
import subprocess
from typing import Iterator, Optional

import numpy as np

__all__ = [
    "read_video_frames",
    "video_info",
    "MjpegAviWriter",
    "write_video",
    "ffmpeg_available",
]

_FFMPEG_EXTS = (".mp4", ".mov", ".mkv", ".webm", ".m4v", ".mpg", ".mpeg", ".wmv", ".flv")


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


# ---------------------------------------------------------------------- AVI -

def _riff_chunks(buf: memoryview, start: int, end: int):
    """Yield (fourcc, payload_start, payload_size) walking a RIFF chunk run."""
    pos = start
    while pos + 8 <= end:
        fourcc = bytes(buf[pos : pos + 4])
        size = struct.unpack("<I", buf[pos + 4 : pos + 8])[0]
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def _read_avi_frames(path: str, ingest: str = "rgb") -> Iterator:
    from PIL import Image

    with open(path, "rb") as f:
        data = memoryview(f.read())
    if bytes(data[:4]) != b"RIFF" or bytes(data[8:12]) != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")

    def walk(start, end):
        for fourcc, payload, size in _riff_chunks(data, start, end):
            if fourcc == b"LIST":
                list_type = bytes(data[payload : payload + 4])
                if list_type in (b"movi", b"rec "):
                    yield from walk(payload + 4, payload + size)
                elif list_type == b"hdrl":
                    continue
            elif fourcc[2:] in (b"dc", b"db") and size > 0:
                yield payload, size

    for payload, size in walk(12, len(data)):
        jpeg = bytes(data[payload : payload + size])
        if not jpeg.startswith(b"\xff\xd8"):
            raise ValueError("AVI stream is not MJPEG (frame is not a JPEG); "
                             "re-encode with MJPEG or install ffmpeg")
        if ingest in ("dct420", "dct420s"):
            # each MJPEG frame IS a JPEG: ship its stored coefficients
            # (native jpeg_mem_src reader, no host IDCT) to the engine's
            # entropy-domain ingest
            from facedet_tpu_torch.data.native_loader import decode_jpeg_bytes_dct420

            d = decode_jpeg_bytes_dct420(jpeg)
            if d is None:
                raise ValueError("undecodable MJPEG frame")
            yield d
            continue
        img = Image.open(io.BytesIO(jpeg)).convert("RGB")
        yield np.asarray(img)


def _avi_header_info(path: str) -> dict:
    with open(path, "rb") as f:
        data = memoryview(f.read(64 * 1024))
    info = {}

    def walk(start, end):
        for fourcc, payload, size in _riff_chunks(data, start, min(end, len(data) - 8)):
            if fourcc == b"LIST":
                walk(payload + 4, payload + size)
            elif fourcc == b"avih" and size >= 40:
                (us_per_frame, _, _, _, total_frames, _, _, _, w, h) = struct.unpack(
                    "<10I", data[payload : payload + 40]
                )
                info.update(
                    width=w, height=h, num_frames=total_frames,
                    fps=1e6 / us_per_frame if us_per_frame else 0.0,
                )

    walk(12, len(data))
    return info


class MjpegAviWriter:
    """Minimal MJPEG AVI muxer: numpy RGB frames in, a standards-conforming
    .avi out (headers written on close, idx1 index included).

    Streaming memory plan: encoded frames append to a ``<path>.movi.tmp``
    spool file as they arrive — O(1) RAM regardless of video length (an
    hour of 1080p MJPEG is tens of GB; buffering frames in a list OOMs).
    Only the 16-byte-per-frame index entries stay in memory; close() writes
    header + stream-copies the spool + appends idx1."""

    def __init__(self, path: str, fps: float = 25.0, quality: int = 90):
        self.path = path
        self.fps = fps
        self.quality = quality
        self._spool_path = path + ".movi.tmp"
        self._spool = None
        self._lengths: list[int] = []
        self._size: Optional[tuple[int, int]] = None
        self._closed = False

    def write(self, frame: np.ndarray) -> None:
        from PIL import Image

        h, w = frame.shape[:2]
        if self._size is None:
            self._size = (w, h)
        elif self._size != (w, h):
            raise ValueError(f"frame size changed {self._size} -> {(w, h)}")
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(frame.astype(np.uint8))).save(
            buf, "JPEG", quality=self.quality
        )
        jpeg = buf.getvalue()
        if self._spool is None:
            self._spool = open(self._spool_path, "wb")
        self._spool.write(b"00dc" + struct.pack("<I", len(jpeg)) + jpeg)
        if len(jpeg) & 1:
            self._spool.write(b"\x00")
        self._lengths.append(len(jpeg))

    def close(self) -> None:
        if self._closed:
            return  # idempotent: a second close must not truncate the output
        if self._size is None or self._spool is None:
            raise ValueError("no frames written")
        self._closed = True
        self._spool.close()
        w, h = self._size
        n = len(self._lengths)
        us_per_frame = int(round(1e6 / max(self.fps, 1e-6)))

        def chunk(fourcc: bytes, payload: bytes) -> bytes:
            pad = b"\x00" if len(payload) & 1 else b""
            return fourcc + struct.pack("<I", len(payload)) + payload + pad

        def lst(list_type: bytes, payload: bytes) -> bytes:
            return chunk(b"LIST", list_type + payload)

        max_bytes = max(self._lengths)
        movi_payload_size = sum(
            8 + ln + (ln & 1) for ln in self._lengths
        )
        avih = struct.pack(
            "<14I", us_per_frame, max_bytes * int(self.fps + 1), 0, 0x10,  # HASINDEX
            n, 0, 1, max_bytes, w, h, 0, 0, 0, 0,
        )
        strh = (
            b"vids" + b"MJPG" + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1,
                                            int(round(self.fps)), 0, n, max_bytes,
                                            0xFFFFFFFF, 0)
            + struct.pack("<4H", 0, 0, w, h)
        )
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                           w * h * 3, 0, 0, 0, 0)
        hdrl = lst(
            b"hdrl",
            chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)),
        )
        idx, offset = [], 4
        for ln in self._lengths:
            idx.append(struct.pack("<4sIII", b"00dc", 0x10, offset, ln))
            offset += 8 + ln + (ln & 1)
        idx1 = chunk(b"idx1", b"".join(idx))
        # movi LIST header written explicitly; payload stream-copied from the
        # spool so frame bytes never accumulate in RAM
        movi_header = b"LIST" + struct.pack("<I", 4 + movi_payload_size) + b"movi"
        riff_size = 4 + len(hdrl) + len(movi_header) + movi_payload_size + len(idx1)
        with open(self.path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", riff_size) + b"AVI ")
            f.write(hdrl)
            f.write(movi_header)
            with open(self._spool_path, "rb") as spool:
                shutil.copyfileobj(spool, f, length=4 * 1024 * 1024)
            f.write(idx1)
        os.remove(self._spool_path)

    def _discard_spool(self) -> None:
        if self._spool is not None and not self._closed:
            self._closed = True
            self._spool.close()
            if os.path.exists(self._spool_path):
                os.remove(self._spool_path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0]:
            # error path: drop the spool, leave no partial output
            self._discard_spool()
        elif self._lengths:
            self.close()

    def __del__(self):
        # abandoned writer (no close(), no with-block): don't leave a
        # potentially many-GB spool file on disk
        try:
            self._discard_spool()
        except Exception:
            pass


# ---------------------------------------------------------------------- Y4M -

def _yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    # one BT.601 implementation in the package: ops/color.py owns the matrix
    from facedet_tpu_torch.ops.color import yuv420_to_rgb_np

    return yuv420_to_rgb_np(y, np.stack([u, v], -1))


def _read_y4m_frames(path: str, ingest: str = "rgb") -> Iterator:
    """``ingest="yuv420"`` yields each frame's stored planes as
    (Y [H,W], UV [H/2,W/2,2]) with ZERO host conversion — Y4M is already
    planar 4:2:0, the exact layout of the engine's yuv420 upload path."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii", errors="replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"{path}: not a Y4M file")
        w = h = 0
        for tok in header.split()[1:]:
            if tok[0] == "W":
                w = int(tok[1:])
            elif tok[0] == "H":
                h = int(tok[1:])
            elif tok[0] == "C" and not tok[1:].startswith("420"):
                raise ValueError(f"Y4M chroma {tok[1:]} unsupported (only 4:2:0)")
        ysize, csize = w * h, (w // 2) * (h // 2)
        while True:
            line = f.readline()
            if not line:
                return
            if not line.startswith(b"FRAME"):
                raise ValueError("corrupt Y4M frame marker")
            raw = f.read(ysize + 2 * csize)
            if len(raw) < ysize + 2 * csize:
                return
            y = np.frombuffer(raw[:ysize], np.uint8).reshape(h, w)
            u = np.frombuffer(raw[ysize : ysize + csize], np.uint8).reshape(h // 2, w // 2)
            v = np.frombuffer(raw[ysize + csize :], np.uint8).reshape(h // 2, w // 2)
            if ingest == "yuv420":
                yield y, np.stack([u, v], axis=-1)
            else:
                yield _yuv420_to_rgb(y, u, v)


def _y4m_info(path: str) -> dict:
    with open(path, "rb") as f:
        header = f.readline().decode("ascii", errors="replace").split()
    info = {"fps": 25.0}
    for tok in header[1:]:
        if tok[0] == "W":
            info["width"] = int(tok[1:])
        elif tok[0] == "H":
            info["height"] = int(tok[1:])
        elif tok[0] == "F":
            num, den = tok[1:].split(":")
            info["fps"] = float(num) / float(den)
    return info


# ------------------------------------------------------------------- ffmpeg -

def _ffprobe_info(path: str) -> dict:
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0", "-show_entries",
         "stream=width,height,r_frame_rate", "-of", "csv=p=0", path],
        capture_output=True, text=True, check=True,
    ).stdout.strip().split(",")
    w, h = int(out[0]), int(out[1])
    num, den = out[2].split("/")
    return {"width": w, "height": h, "fps": float(num) / max(float(den), 1.0)}


def _read_ffmpeg_frames(path: str) -> Iterator[np.ndarray]:
    info = _ffprobe_info(path)
    w, h = info["width"], info["height"]
    proc = subprocess.Popen(
        ["ffmpeg", "-v", "error", "-i", path, "-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
        stdout=subprocess.PIPE,
    )
    try:
        frame_bytes = w * h * 3
        while True:
            raw = proc.stdout.read(frame_bytes)
            if len(raw) < frame_bytes:
                break
            yield np.frombuffer(raw, np.uint8).reshape(h, w, 3).copy()
    finally:
        proc.stdout.close()
        proc.wait()


# ------------------------------------------------------------------- public -

def video_info(path: str) -> dict:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".avi":
        return _avi_header_info(path)
    if ext == ".y4m":
        return _y4m_info(path)
    if ffmpeg_available():
        return _ffprobe_info(path)
    raise RuntimeError(
        f"cannot probe {ext} without ffmpeg; use MJPEG .avi or .y4m, or install ffmpeg"
    )


def read_video_frames(path: str, ingest: str = "rgb") -> Iterator:
    """Yield frames (RGB uint8 arrays — or DctImage with ingest="dct420")
    from a video file. MJPEG AVI and Y4M decode natively; other containers
    require an ffmpeg binary on PATH.

    ``ingest="dct420"`` yields each MJPEG-AVI frame as a
    :class:`~facedet_tpu_torch.ops.jpeg_dct.DctImage` of the frame's own stored
    JPEG coefficients (lossless, zero host IDCT) for the engine's
    entropy-domain upload path; non-MJPEG sources still yield RGB frames,
    which the engine re-encodes on the fly under the same input_format."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".avi":
        # MJPEG decodes natively; other AVI codecs (H.264 etc.) fall back to
        # ffmpeg when available instead of dead-ending with advice to
        # "install ffmpeg" on a host that already has it. Only fall back
        # before the first yielded frame (the codec check fires on frame 0;
        # restarting mid-stream would duplicate frames).
        produced = False
        try:
            for frame in _read_avi_frames(path, ingest=ingest):
                produced = True
                yield frame
            return
        except ValueError:
            if produced or not ffmpeg_available():
                raise
        yield from _read_ffmpeg_frames(path)
    elif ext == ".y4m":
        yield from _read_y4m_frames(
            path, ingest="yuv420" if ingest == "yuv420" else "rgb"
        )
    elif ext in _FFMPEG_EXTS or ffmpeg_available():
        if not ffmpeg_available():
            raise RuntimeError(
                f"decoding {ext} needs an ffmpeg binary on PATH (none found); "
                "MJPEG .avi and .y4m decode natively"
            )
        yield from _read_ffmpeg_frames(path)
    else:
        raise ValueError(f"unsupported video container {ext!r}")


def write_video(path: str, frames, fps: float = 25.0, quality: int = 90) -> int:
    """Write RGB frames to an MJPEG AVI. Returns the frame count."""
    n = 0
    with MjpegAviWriter(path, fps=fps, quality=quality) as w:
        for frame in frames:
            w.write(frame)
            n += 1
    return n
