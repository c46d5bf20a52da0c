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


def test_device_time_on_the_cpu_gives_wall_ms_and_no_device_number():
    calls = []
    x = torch.ones(4)
    row = tprof.device_time(lambda t: calls.append(1) or t * 2, x, warmup=2, iters=5, profile_iters=3)
    assert len(calls) == 7  # warmup and timed calls; nothing profiled where there is no device
    assert row["device"] == "cpu" and row["wall_ms"] >= 0
    assert row["device_ms"] is None and row["launches"] is None and row["busy"] is None and row["groups"] == {}
    per = tprof.per_unit(row, 4)
    assert per["wall_ms"] == row["wall_ms"] / 4 and per["device_ms"] is None
    assert "device not measured" in tprof.format_row("x", per)
    with pytest.raises(ValueError, match="pass device="):
        tprof.device_time(lambda: None)


class _Event:
    def __init__(self, key, ms, count):
        self.key, self.self_device_time_total, self.count = key, ms * 1e3, count


class _CudaEvent:  # stands in for torch.cuda.Event: every call takes 1 ms
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


@pytest.mark.parametrize("windows_ms, want", [((0.05, 0.2), 0.2), ((0.05, 0.05, 0.05), None)])
def test_device_time_takes_again_a_window_under_the_least_device_time(monkeypatch, capsys, windows_ms, want):
    """A profiler window whose device ms per call is under ``min_device_ms``
    (the card would have beaten its peak) is taken again, as a window that
    lost its markers is; after three it raises."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _CudaEvent)
    windows = iter(windows_ms)
    monkeypatch.setattr(tprof, "_profile_window",
                        lambda fn, args, n, device: ([_Event("conv_kernel", next(windows) * n, n)], 0, 0))
    run = lambda: tprof.device_time(lambda: None, device="cuda", warmup=0, iters=3, profile_iters=2,  # noqa: E731
                                    min_device_ms=0.1)
    if want is None:
        with pytest.raises(RuntimeError, match="no whole profiler window"):
            run()
        return
    row = run()
    assert row["device_ms"] == pytest.approx(want) and row["wall_ms"] == 1.0 and row["launches"] == 1
    assert "taking another" in capsys.readouterr().out


@pytest.mark.parametrize("windows, taken", [([(64, 0), (0, 0)], 2), ([(0, 1), (70, 0), (64, 0)], None),
                                            ([(63, 0)], 1)])
def test_profile_kernels_takes_again_a_window_short_or_mixed(monkeypatch, capsys, windows, taken):
    """The guarded window of chip_smoke.py's profiles: a window that missed
    all 64 marker kernels on one side of its calls, or held an extra one, is
    printed and taken again, the calls run anew; after three it raises.
    Fewer than 64 missing on each side still counts."""
    seen = iter(windows)
    calls = []

    def window(fn, args, n, device):
        for _ in range(n):
            fn(*args)
        missing, extra = next(seen)
        return [_Event("conv_kernel", 0.5 * n, n)], missing, extra

    monkeypatch.setattr(tprof, "_profile_window", window)
    run = lambda: tprof.profile_kernels(calls.append, 1, n=2)  # noqa: E731
    if taken is None:
        with pytest.raises(RuntimeError, match="no whole profiler window in 3"):
            run()
        assert len(calls) == 6 and capsys.readouterr().out.count("taking another") == 3
        return
    kernels = run()
    assert [e.key for e in kernels] == ["conv_kernel"] and len(calls) == 2 * taken
    assert capsys.readouterr().out.count("taking another") == taken - 1


class _Record:  # stands in for a FunctionEvent and a key_averages() row of the card
    def __init__(self, name, start):
        self.name = self.key = name
        self.time_range = type("Interval", (), {"start": start})()
        self.device_type = torch.autograd.DeviceType.CUDA
        self.count, self.self_device_time_total = 1, 10.0


class _Profile:  # stands in for torch.profiler.profile; its window yields ``order``
    order = ""

    def __init__(self, activities):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        names = {"M": "spin_kernel", "K": "conv_kernel"}
        return [_Record(names[c], t) for t, c in enumerate(self.order)]

    def key_averages(self):
        return self.events()


@pytest.mark.parametrize("order, missing, extra", [
    ("M" * 64 + "KKK" + "M" * 64, 0, 0),  # whole
    ("M" * 54 + "KKK" + "M" * 64, 10, 0),  # the first records lost: the calls all came
    ("M" * 10 + "KKK", 64, 0),  # the trailing side lost: the calls' last records may be too
    ("KKK" + "M" * 128, 64, 0),  # a kernel before the leading markers: another window's
    ("M" * 64 + "KKK" + "M" * 65, 0, 1),  # an extra marker: another window's
])
def test_profile_window_reads_the_markers_on_each_side_of_the_calls(monkeypatch, order, missing, extra):
    """``_profile_window`` reports, by the records' start times, the markers
    missing on the side of the calls that lacks more of them, and the extra
    markers; ``profile_kernels`` retakes a window with ``missing`` 64 (no
    marker on one side) or any extra."""
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(_Profile, "order", order)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    kernels, got_missing, got_extra = tprof._profile_window(calls.append, (1,), 2, "cuda")
    assert (got_missing, got_extra) == (missing, extra) and calls == [1, 1]
    assert [e.key for e in kernels] == ["conv_kernel"] * 3


def test_kernel_groups_match_the_first_group_by_name():
    events = [_Event("void at::native::tile_gather_chw_kernel", 1.0, 2), _Event("sm90_xmma_fprop_implicit_gemm", 6.0, 4),
              _Event("Memcpy HtoD (Pageable -> Device)", 0.5, 2), _Event("some_unknown_kernel", 0.2, 2)]
    groups = tprof.kernel_groups(events, n=2)
    assert list(groups) == ["convolution and matmul", "tile gather", "host-device copies", "other"]
    assert groups["convolution and matmul"] == [3.0, 2.0] and groups["other"] == [0.1, 1.0]


def test_tree_sum_takes_every_field_as_float32():
    from facedet_tpu_torch.core.detections import Detections

    det = Detections(torch.ones(2, 4), torch.full((2,), 0.5), torch.ones(2, dtype=torch.int32),
                     torch.ones(2, 5, 3), torch.tensor([True, False]))
    assert float(tprof.tree_sum([det, {"a": torch.ones(3, dtype=torch.bfloat16)}, None])) == 8 + 1 + 2 + 30 + 1 + 3


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
