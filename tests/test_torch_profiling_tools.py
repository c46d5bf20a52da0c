"""The port's profiling utilities (facedet_tpu_torch/utils/profiling.py) and
debug tools (tools/debug_inference.py, tools/debug_slicing.py) against the
JAX package's on the CPU.

Tolerances: ``flops_and_params`` of one conv exactly 2 x its multiply-adds
(torch's count; XLA's is not compared) and its parameter count equal to
JAX's; the key sets of ``measure_latency`` and the debug rows equal JAX's;
``debug_slicing`` and ``compare_direct_vs_wrapper`` on the fake detector
and on the golden yolo11n give JAX's rows: equal counts (per tile, merged,
per letterbox size), score ranges within 1e-3, box sizes within 0.05 px.
"""
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxYolo
from facedet_tpu.engine.fake import FakeBlobDetectionModel as JaxFake
from facedet_tpu.tools import debug_inference as jdi
from facedet_tpu.tools import debug_slicing as jds
from facedet_tpu.utils import profiling as jprof
from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
from facedet_tpu_torch.engine.fake import FakeBlobDetectionModel
from facedet_tpu_torch.tools import debug_inference as tdi
from facedet_tpu_torch.tools import debug_slicing as tds
from facedet_tpu_torch.utils import profiling as tprof
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)

YOLO_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")


def test_stopwatch_accumulates_phases():
    sw = tprof.Stopwatch()
    for _ in range(2):
        with sw.phase("a"):
            pass
    with sw.phase("b"):
        pass
    assert set(sw.durations) == {"a", "b"} and all(v >= 0 for v in sw.durations.values())


def test_measure_latency_keys_equal_jax():
    got = tprof.measure_latency(lambda x: x + 1, torch.zeros(4), warmup=1, iters=3)
    want = jprof.measure_latency(lambda x: x + 1, jnp.zeros(4), warmup=1, iters=3)
    assert set(got) == set(want)
    assert got["min_ms"] <= got["p50_ms"] and got["fps"] > 0


def test_flops_of_one_conv_are_twice_its_macs_and_params_equal_jax():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    x = torch.zeros(2, 3, 16, 16)
    got = tprof.flops_and_params(conv, x, params=conv)
    macs = 2 * 8 * 16 * 16 * 3 * 3 * 3
    assert got["flops"] == 2 * macs and got["gflops"] == 2 * macs / 1e9
    flax_conv = fnn.Conv(8, (3, 3))
    params = flax_conv.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)))
    want = jprof.flops_and_params(lambda v, y: flax_conv.apply(v, y), params, jnp.zeros((2, 16, 16, 3)), params=params)
    assert got["params"] == want["params"] == 8 * 3 * 9 + 8


def test_device_memory_stats_is_empty_on_the_cpu():
    assert tprof.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert tprof.device_memory_stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(8).sum()
    path = os.path.join(log_dir, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as fh:
        assert "traceEvents" in json.load(fh)


def dots(h, w, centres):
    img = np.zeros((h, w, 3), np.uint8)
    for y, x in centres:
        img[y - 1 : y + 2, x - 1 : x + 2] = 255
    return img


@pytest.fixture(scope="module")
def detectors():
    return {
        "fake": (FakeBlobDetectionModel(confidence_threshold=0.5, image_size=64, device="cpu"),
                 JaxFake(confidence_threshold=0.5, image_size=64),
                 dots(150, 200, [(30, 40), (120, 180)]), 64),
        "yolo": (YoloV11PoseDetectionModel(model_path=YOLO_CKPT, scale="n", dtype="float32",
                                           confidence_threshold=0.25, image_size=320, device="cpu"),
                 JaxYolo(model_path=YOLO_CKPT, scale="n", dtype="float32", confidence_threshold=0.25, image_size=320),
                 synthetic_faces(512, 768, seed=2), 320),
    }


def _same_rows(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["imgsz"], g["detections"], g["memory"]) == (w["imgsz"], w["detections"], w["memory"])
        for k in ("conf_min", "conf_max"):
            assert (g[k] is None) == (w[k] is None)
            if w[k] is not None:
                assert abs(g[k] - w[k]) <= 1e-3, k
        if w["box_size_mean"] is not None:
            assert abs(g["box_size_mean"] - w["box_size_mean"]) <= 0.05


@pytest.mark.parametrize("name", ["fake", "yolo"])
def test_compare_direct_vs_wrapper_rows_equal_jax(detectors, name):
    port, ref, image, size = detectors[name]
    sizes = (size, 2 * size)
    got = tdi.compare_direct_vs_wrapper(image, port, image_sizes=sizes)
    want = jdi.compare_direct_vs_wrapper(image, ref, image_sizes=sizes)
    _same_rows(got, want)
    assert port.image_size == size
    if name == "yolo":
        assert got[1]["detections"] >= 3
        info = tdi.wrapper_config_info(port)
        assert set(info) == set(jdi.wrapper_config_info(ref))
        kp = tdi.debug_keypoints(image, port)
        assert kp["has_keypoints"] and kp["kpts_shape"][1:] == [5, 3]
        assert kp["num_detections"] == jdi.debug_keypoints(image, ref)["num_detections"]


@pytest.mark.parametrize("name", ["fake", "yolo"])
def test_debug_slicing_rows_equal_jax(detectors, name, tmp_path):
    port, ref, image, size = detectors[name]
    got = tds.debug_slicing(image, port, str(tmp_path / "port"), slice_size=size, overlap=0.2)
    want = jds.debug_slicing(image, ref, str(tmp_path / "jax"), slice_size=size, overlap=0.2)
    assert got == want
    assert got["merged_detections"] >= 2
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert "merged.jpg" in files and f"tile_{got['num_tiles'] - 1:02d}_det.jpg" in files
