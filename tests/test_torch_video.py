"""The port's video IO (facedet_tpu_torch/data/video.py), ``predict_video``
and ``FaceDetector``'s video and webcam modes against the JAX package's, on
the CPU: the counterparts of tests/test_video.py's cases.

Tolerances: AVI files written by both packages equal byte for byte, decoded
frames equal exactly (one decoder, the same bytes); the fake detector's
detections per frame under PERF.md §2's gates (equal counts, boxes 0.05 px,
scores 1e-3) and each frame's detections equal to ``get_sliced_prediction``
on that frame; RT-DETR (weights carried from flax, float32) per frame the
same counts.
"""
import io
import json
import os
import struct

import numpy as np
import pytest
import torch

from facedet_tpu.data import video as jvideo
from facedet_tpu_torch.data import video as tvideo
from facedet_tpu_torch.data.video import MjpegAviWriter, read_video_frames, video_info, write_video

torch.set_num_threads(1)


def smooth_frames(n=5, h=64, w=80, seed=0):
    """Low-frequency frames so JPEG round-trip error stays small."""
    rng = np.random.default_rng(seed)
    return [np.kron(rng.uniform(40, 200, (4, 5, 3)), np.ones((h // 4, w // 5, 1))).astype(np.uint8) for _ in range(n)]


def test_mjpeg_avi_roundtrip_is_the_jax_file(tmp_path):
    frames = smooth_frames(6)
    path, jpath = str(tmp_path / "clip.avi"), str(tmp_path / "jclip.avi")
    assert write_video(path, frames, fps=10.0, quality=95) == 6
    jvideo.write_video(jpath, frames, fps=10.0, quality=95)
    assert open(path, "rb").read() == open(jpath, "rb").read()

    info = video_info(path)
    assert info == jvideo.video_info(path)
    assert info["width"] == 80 and info["height"] == 64
    assert info["num_frames"] == 6 and abs(info["fps"] - 10.0) < 0.1
    got, want = list(read_video_frames(path)), list(jvideo.read_video_frames(path))
    assert len(got) == len(want) == 6
    for g, w, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, w)
        assert np.mean(np.abs(g.astype(float) - f.astype(float))) < 4.0  # JPEG loss
    assert not os.path.exists(path + ".movi.tmp")


def test_avi_is_standard_riff(tmp_path):
    path = str(tmp_path / "c.avi")
    write_video(path, smooth_frames(3, h=48, w=60), fps=5)
    raw = open(path, "rb").read()
    assert raw[:4] == b"RIFF" and raw[8:12] == b"AVI "
    assert struct.unpack("<I", raw[4:8])[0] == len(raw) - 8  # RIFF size field
    assert b"movi" in raw and b"idx1" in raw and b"MJPG" in raw


def write_y4m(path, frames, fps=(10, 1)):
    h, w = frames[0].shape[:2]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps[0]}:{fps[1]} Ip A1:1 C420jpeg\n".encode())
        for fr in frames:
            f.write(b"FRAME\n")  # gray frames: Y = value, U = V = 128
            f.write(fr[..., 0].astype(np.uint8).tobytes())
            f.write(np.full((h // 2, w // 2), 128, np.uint8).tobytes())
            f.write(np.full((h // 2, w // 2), 128, np.uint8).tobytes())


def test_y4m_reader(tmp_path):
    path = str(tmp_path / "clip.y4m")
    vals = [30, 90, 200]
    write_y4m(path, [np.full((32, 48, 3), v, np.uint8) for v in vals])
    info = video_info(path)
    assert info == jvideo.video_info(path) and (info["width"], info["height"]) == (48, 32)
    got = list(read_video_frames(path))
    assert len(got) == 3
    for g, w, v in zip(got, jvideo.read_video_frames(path), vals):
        np.testing.assert_array_equal(g, w)
        assert g.shape == (32, 48, 3) and np.all(np.abs(g.astype(int) - v) <= 1)


def test_frame_size_change_rejected_and_spool_cleanup(tmp_path):
    w = MjpegAviWriter(str(tmp_path / "x.avi"))
    w.write(np.zeros((16, 16, 3), np.uint8))
    with pytest.raises(ValueError):
        w.write(np.zeros((8, 16, 3), np.uint8))
    # an error inside the with-block leaves neither output nor spool
    path = str(tmp_path / "y.avi")
    with pytest.raises(RuntimeError):
        with MjpegAviWriter(path) as writer:
            writer.write(np.zeros((16, 16, 3), np.uint8))
            raise RuntimeError("inference failed")
    assert not os.path.exists(path) and not os.path.exists(path + ".movi.tmp")
    with pytest.raises(ValueError, match="unsupported"):
        list(read_video_frames(__file__))  # a .py is no container
    with pytest.raises(FileNotFoundError):
        list(read_video_frames(str(tmp_path / "none.avi")))


def blob_video(tmp_path, n=4, h=96, w=120):
    """Frames with one bright blob each at known positions."""
    centers = [(30, 40), (60, 80), (20, 100), (70, 30)][:n]
    frames = []
    for cy, cx in centers:
        img = np.zeros((h, w, 3), np.uint8)
        img[cy - 2 : cy + 3, cx - 2 : cx + 3] = 255
        frames.append(img)
    path = str(tmp_path / "blobs.avi")
    write_video(path, frames, fps=5, quality=98)
    return path, centers


def _fake_models(**kw):
    from facedet_tpu.engine.fake import FakeBlobDetectionModel as JaxFake
    from facedet_tpu_torch.engine.fake import FakeBlobDetectionModel

    return FakeBlobDetectionModel(device="cpu", **kw), JaxFake(**kw)


def _by_frame(dets):
    out = {}
    for d in dets:
        out.setdefault(d["image_id"], []).append(d)
    return out


def _assert_same_coco(got, want):
    g, w = _by_frame(got), _by_frame(want)
    assert set(g) == set(w)
    for k in w:
        assert len(g[k]) == len(w[k])
        np.testing.assert_allclose([d["bbox"] for d in g[k]], [d["bbox"] for d in w[k]], atol=0.05)
        np.testing.assert_allclose([d["score"] for d in g[k]], [d["score"] for d in w[k]], atol=1e-3)


@pytest.mark.parametrize("ingest", ["rgb", "dct420"])
def test_predict_video_end_to_end(tmp_path, ingest):
    """predict() on an MJPEG AVI, both packages: per-frame COCO detections
    on the blob centers and equal, an annotated AVI the reader opens, and
    every frame's detections equal get_sliced_prediction on the frame
    predict_video decoded."""
    from facedet_tpu.engine.batch_predict import predict as jax_predict
    from facedet_tpu_torch import get_sliced_prediction, predict

    path, centers = blob_video(tmp_path)
    model, jmodel = _fake_models(confidence_threshold=0.5, image_size=64)
    kw = dict(source=path, slice_height=64, slice_width=64, no_standard_prediction=True, verbose=0)
    out = predict(detection_model=model, project=str(tmp_path / "runs"), ingest=ingest, **kw)
    jout = jax_predict(detection_model=jmodel, project=str(tmp_path / "jruns"), ingest=ingest, **kw)
    assert out["num_frames"] == jout["num_frames"] == len(centers)
    dets = json.load(open(os.path.join(out["export_dir"], "result.json")))
    _assert_same_coco(dets, json.load(open(os.path.join(jout["export_dir"], "result.json"))))
    assert {d["image_id"] for d in dets} == set(range(len(centers)))
    for d, (cy, cx) in zip(sorted(dets, key=lambda d: d["image_id"]), centers):
        x, y, bw, bh = d["bbox"]
        assert abs(x + bw / 2 - cx) <= 2 and abs(y + bh / 2 - cy) <= 2
    vids = [f for f in os.listdir(out["export_dir"]) if f.endswith(".avi")]
    assert vids == ["blobs_detections.avi"]
    assert len(list(read_video_frames(os.path.join(out["export_dir"], vids[0])))) == len(centers)
    by_frame = _by_frame(dets)
    for i, frame in enumerate(read_video_frames(path, ingest=ingest)):
        single = get_sliced_prediction(frame, model, slice_height=64, slice_width=64, perform_standard_pred=False,
                                       input_format=ingest).to_coco_predictions(image_id=i)
        _assert_same_coco(by_frame[i], single)


def test_predict_video_frame_skip_and_standard_only(tmp_path):
    """frame_skip keeps every (skip+1)-th frame and slows the written fps to
    match; no_sliced_prediction runs get_prediction per frame; both as JAX."""
    from facedet_tpu.engine.batch_predict import predict_video as jax_predict_video
    from facedet_tpu_torch.engine.batch_predict import predict_video

    path, centers = blob_video(tmp_path)
    model, jmodel = _fake_models(confidence_threshold=0.5, image_size=64)
    for kw in (dict(frame_skip=1, slice_height=64, slice_width=64, no_standard_prediction=True),
               dict(no_sliced_prediction=True)):
        out = predict_video(detection_model=model, source=path, project=str(tmp_path / "r"), verbose=0, **kw)
        jout = jax_predict_video(detection_model=jmodel, source=path, project=str(tmp_path / "j"), verbose=0, **kw)
        assert out["num_frames"] == jout["num_frames"] == (2 if "frame_skip" in kw else 4)
        _assert_same_coco(json.load(open(os.path.join(out["export_dir"], "result.json"))),
                          json.load(open(os.path.join(jout["export_dir"], "result.json"))))
        annotated = os.path.join(out["export_dir"], "blobs_detections.avi")
        assert video_info(annotated)["fps"] == pytest.approx(5.0 / (kw.get("frame_skip", 0) + 1), rel=1e-3)


def test_decode_jpeg_bytes_dct420_matches_file_reader(tmp_path):
    """The in-memory coefficient reader returns the file reader's planes
    for the same JPEG bytes, and the JAX package's."""
    from PIL import Image

    from facedet_tpu.data.native_loader import decode_jpeg_bytes_dct420 as jax_decode
    from facedet_tpu_torch.data.native_loader import decode_jpeg_bytes_dct420, load_image_dct420

    rng = np.random.default_rng(11)
    img = np.clip(np.kron(rng.integers(40, 200, (6, 8, 3)), np.ones((16, 16, 1))), 0, 255).astype(np.uint8)
    path = str(tmp_path / "m.jpg")
    Image.fromarray(img).save(path, quality=90, subsampling=2)
    data = open(path, "rb").read()
    d_file, d_mem, d_jax = load_image_dct420(path), decode_jpeg_bytes_dct420(data), jax_decode(data)
    assert tuple(d_mem.hw) == tuple(d_file.hw) == tuple(d_jax.hw)
    for name in ("y_dc", "y_ac", "uv_dc", "uv_ac", "qy"):
        np.testing.assert_array_equal(getattr(d_mem, name), getattr(d_file, name))
        np.testing.assert_array_equal(getattr(d_mem, name), getattr(d_jax, name))


def test_y4m_yuv420_plane_passthrough(tmp_path):
    """ingest="yuv420" on a Y4M yields the stored planes untouched, and
    predict_video runs them through the planar upload path, as JAX."""
    from facedet_tpu.engine.batch_predict import predict_video as jax_predict_video
    from facedet_tpu_torch.engine.batch_predict import predict_video
    from facedet_tpu_torch.ops.color import rgb_to_yuv420

    h, w = 96, 128
    path = str(tmp_path / "clip.y4m")
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F5:1 C420\n".encode())
        for cx in (40, 80):
            img = np.zeros((h, w, 3), np.uint8)
            img[30:33, cx - 1 : cx + 2] = 255
            y, uv = rgb_to_yuv420(img)
            f.write(b"FRAME\n" + y.tobytes() + uv[..., 0].tobytes() + uv[..., 1].tobytes())
    planes = list(read_video_frames(path, ingest="yuv420"))
    assert len(planes) == 2 and isinstance(planes[0], tuple)
    assert planes[0][0].shape == (h, w) and planes[0][1].shape == (h // 2, w // 2, 2)
    for (y, uv), (jy, juv) in zip(planes, jvideo.read_video_frames(path, ingest="yuv420")):
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(uv, juv)
    model, jmodel = _fake_models(confidence_threshold=0.5)
    kw = dict(source=path, slice_height=64, slice_width=64, no_standard_prediction=True, verbose=0, ingest="yuv420")
    out = predict_video(detection_model=model, project=str(tmp_path / "runs"), **kw)
    jout = jax_predict_video(detection_model=jmodel, project=str(tmp_path / "jruns"), **kw)
    assert out["num_frames"] == 2
    dets = json.load(open(os.path.join(out["export_dir"], "result.json")))
    assert len(dets) == 2
    _assert_same_coco(dets, json.load(open(os.path.join(jout["export_dir"], "result.json"))))


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    """FaceDetector (rtdetr-tiny, float32) in both packages with the same
    flax weights (the JAX init, carried by file)."""
    import jax
    import jax.numpy as jnp

    from facedet_tpu.engine.rtdetr_wrapper import FaceDetector as JaxFaceDetector
    from facedet_tpu.models.rtdetr import RTDETR_VARIANTS, RtDetr
    from facedet_tpu_torch.engine.detector import save_params_npz
    from facedet_tpu_torch.engine.rtdetr_wrapper import FaceDetector

    variables = RtDetr(RTDETR_VARIANTS["rtdetr-tiny"]).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    path = str(tmp_path_factory.mktemp("w") / "rtdetr_tiny.npz")
    save_params_npz(path, jax.tree.map(np.asarray, variables))
    pair = (FaceDetector(model_path=path, variant="rtdetr-tiny", conf=0.3, image_size=64, device="cpu"),
            JaxFaceDetector(model_path=path, variant="rtdetr-tiny", conf=0.3, image_size=64))
    for fd in pair:
        fd.model.dtype = "float32"
        fd.model.load_model()
    fd, jfd = pair
    return fd, jfd


def test_facedetector_detect_video(tmp_path, detectors):
    fd, jfd = detectors
    path, _ = blob_video(tmp_path, n=3)
    out = fd.detect_video(path, str(tmp_path / "out.avi"), verbose=False)
    jout = jfd.detect_video(path, str(tmp_path / "jout.avi"), verbose=False)
    assert out["frames"] == jout["frames"] == 3 and out["faces"] == jout["faces"]
    assert len(list(read_video_frames(str(tmp_path / "out.avi")))) == 3
    assert not os.path.exists(str(tmp_path / "out.avi") + ".movi.tmp")
    # webcam mode degrades with a clear error where there is no camera
    with pytest.raises(RuntimeError, match="webcam"):
        list(fd.detect_webcam(device=str(tmp_path / "nonexistent-video")))


class _FakeProcess:
    """``subprocess.Popen`` of ``ffmpeg -f v4l2``: raw rgb24 frames on stdout."""

    def __init__(self, frames):
        self.stdout = io.BytesIO(b"".join(f.tobytes() for f in frames))
        self.terminated = False

    def terminate(self):
        self.terminated = True


def test_detect_webcam_through_stubbed_ffmpeg(tmp_path, monkeypatch, detectors):
    """detect_webcam with ffprobe and ffmpeg stubbed (monkeypatched
    subprocess, a file standing in for the camera): the frames of the pipe
    come back as detections, the same as the JAX package's, max_frames
    honoured and the process ended."""
    import subprocess
    import types

    fd, jfd = detectors
    frames = smooth_frames(4, h=48, w=80, seed=7)
    camera = tmp_path / "video0"
    camera.write_bytes(b"")
    procs, calls = [], []

    def run(cmd, **kw):
        calls.append(cmd[0])
        return types.SimpleNamespace(stdout="80,48\n")

    def popen(cmd, **kw):
        calls.append(cmd[0])
        procs.append(_FakeProcess(frames))
        return procs[-1]

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setattr(tvideo, "ffmpeg_available", lambda: True)
    monkeypatch.setattr(jvideo, "ffmpeg_available", lambda: True)
    got = list(fd.detect_webcam(device=str(camera), max_frames=3))
    want = list(jfd.detect_webcam(device=str(camera), max_frames=3))
    assert calls == ["ffprobe", "ffmpeg"] * 2
    assert len(got) == len(want) == 3 and all(p.terminated for p in procs)
    for g, w, f in zip(got, want, frames):
        np.testing.assert_array_equal(g.image, f)
        assert len(g.object_prediction_list) == len(w.object_prediction_list)
