"""The plain reference against the program, the check against planted
faults, and the guards, on the CPU at small sizes (the program in float32
there, where it and the reference agree to rounding); the control on the
card at each cell's own size (``cuda``).

A run here is ``run.run`` with ``device="cpu"``: everything the benchmark
does but look for a card and time it."""
import ast
import copy
import glob
import io
import os
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest
import torch

from port_bench import harness
from port_bench.run import run

# each entry on the CPU: the mix cut to a few small photos, the program in float32
SMALL = {
    "stream.dct420s": dict(photos=2, height=768, width=1024, faces=24, face_px=[60, 140], format="dct420s"),
    "yolo11n.single_rgb": dict(photos=2, height=768, width=1024, faces=24, face_px=[60, 140], format="rgb"),
    "x2plus_v2.single_rgb": dict(photos=2, height=128, width=192, faces=3, face_px=[25, 40], format="rgb"),
}
SEED = 2**33 + 5
# the serving stream's entry (``drivers/stream.py``), which no cell of
# BENCHMARK.json runs yet: the detector configuration and the limits of
# ``yolo11n.single_rgb``, the serving options of the stream
STREAM = {"driver": "stream", "reference": "sliced", "trace_requests": 4,
          "entry": {"batch_size": 2, "window": 3, "fetch_capacity": 300, "postprocess_class_agnostic": True}}


def small_cell(name: str) -> harness.Cell:
    if name == "stream.dct420s":
        c = harness.cell("yolo11n.single_rgb")
        c.name, c.spec = name, dict(STREAM, limits=c.spec["limits"])
    else:
        c = harness.cell(name)
    c.mix = SMALL[name]
    c.config = copy.deepcopy(c.config)
    for part in ("detector", "enhancer"):
        if part in c.config:
            c.config[part]["dtype"] = "float32"
    return c


def cpu_run(c: harness.Cell, seconds: float = 2.0):
    torch.set_num_threads(4)
    return run(c, SEED, seconds, False, device="cpu", t_start=time.perf_counter())[0]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reference_agrees_with_the_program(name):
    c = small_cell(name)
    result = cpu_run(c)
    assert result["failed"] == 0 and result["attempted"] > 0
    numbers = {k: v["value"] for k, v in result["checks"].items()}
    assert set(numbers) == set(c.spec["limits"]) and numbers
    # float32 on both sides: rounding only, far below the limits set for bfloat16
    for key, value in numbers.items():
        assert value < (0.01 if key == "sr_gap" else 1e-3), (key, numbers)
    assert result["correct"]


def _half_the_batch(monkeypatch, cell):
    """Half of the batch left out: the second half of every tile batch the
    gather produces is zeroed, and so is the second half of every enhancer
    output (whose batch is one window at these sizes)."""
    import facedet_tpu_torch.engine.predict as P
    from facedet_tpu_torch.engine.enhancer import FaceEnhancer

    gather, net = P.gather_tiles_chw, FaceEnhancer._net

    def broken_gather(*args, **kwargs):
        tiles = gather(*args, **kwargs)
        tiles[tiles.shape[0] // 2:] = 0
        return tiles

    def broken_net(self, x):
        out = net(self, x)
        out[..., out.shape[-2] // 2:, :] = 0
        return out

    monkeypatch.setattr(P, "gather_tiles_chw", broken_gather)
    monkeypatch.setattr(FaceEnhancer, "_net", broken_net)


def _answer_moved(monkeypatch, cell):
    """An answer altered where it is produced: every merged box moved 16 px
    to the right before the fetch."""
    import facedet_tpu_torch.engine.predict as P

    clip = P._clip_detections

    def broken(det, h, w):
        out = clip(det, h, w)
        out.boxes[..., 0::2] += 16.0
        return out

    monkeypatch.setattr(P, "_clip_detections", broken)


def _keypoints_moved(monkeypatch, cell):
    """Every keypoint of every merged detection moved 16 px to the right
    before the fetch; boxes and scores as served."""
    import facedet_tpu_torch.engine.predict as P

    clip = P._clip_detections

    def broken(det, h, w):
        out = clip(det, h, w)
        out.kpts[..., 0] += 16.0
        return out

    monkeypatch.setattr(P, "_clip_detections", broken)


# merges each entry's warm-up runs here (stream: 2 batches, single: 3
# requests, enhance-first: 2), so the next one is the measured window's first
WARM_MERGES = {"stream": 2, "single": 3, "pipeline_v2": 2}


def _one_answer_moved(monkeypatch, cell):
    """One answer of the run altered: the boxes of one image (the first of
    its batch) moved 16 px to the right, in the measured window's first
    merge."""
    import facedet_tpu_torch.engine.predict as P

    clip, calls = P._clip_detections, [0]

    def broken(det, h, w):
        out = clip(det, h, w)
        calls[0] += 1
        if calls[0] == WARM_MERGES[cell.spec["driver"]] + 1:
            boxes = out.boxes[0] if out.boxes.dim() == 3 else out.boxes
            boxes[..., 0::2] += 16.0
        return out

    monkeypatch.setattr(P, "_clip_detections", broken)


def _standard_pass_blind(monkeypatch, cell):
    """The letterboxed standard pass sees a black image, so it adds no
    detection to the merge; the tiles run as served."""
    import facedet_tpu_torch.engine.predict as P

    letterbox = P.letterbox_full

    def broken(canvas, true_hw, img_size):
        tiles, scale = letterbox(canvas, true_hw, img_size)
        return torch.zeros_like(tiles), scale

    monkeypatch.setattr(P, "letterbox_full", broken)


FAULTS = [_half_the_batch, _answer_moved, _keypoints_moved, _one_answer_moved, _standard_pass_blind]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    c = small_cell(name)
    fault(monkeypatch, c)
    result = cpu_run(c)
    assert not result["correct"], result["checks"]


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
            if node.module == "port_bench":
                names |= {f"port_bench.{a.name}" for a in node.names}
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("port_bench."):
            names.add(node.module)
    return names


def test_the_reference_imports_neither_jax_nor_the_program():
    files = glob.glob(os.path.join(harness.HERE, "reference", "*.py"))
    seen, queue = set(), list(files)
    while queue:
        path = queue.pop()
        if path in seen:
            continue
        seen.add(path)
        names = _imports(path)
        top = {n.split(".")[0] for n in names}
        assert not top & {"jax", "jaxlib", "flax", "facedet_tpu", "facedet_tpu_torch"}, (path, top)
        for n in names:  # follow the benchmark's own modules the reference uses
            if n.startswith("port_bench."):
                sub = os.path.join(harness.ROOT, *n.split(".")) + ".py"
                if os.path.exists(sub):
                    queue.append(sub)
    assert len(seen) > len(files)  # port_bench.inputs was followed


def test_the_guard_names_jax_and_the_jax_package(monkeypatch):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "facedet_tpu_torch.engine.probe", sys)  # the port passes: its top name differs
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "facedet_tpu.engine", sys)
    assert {"jax", "facedet_tpu"} <= set(harness.forbidden_modules())


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints nothing
    on standard output."""
    out = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload", "yolo11n.single_rgb",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=harness.ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == "", out


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(w["name"] for w in harness.benchmark()["workloads"]))
def test_the_control_fails_the_check_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from port_bench import check
    from port_bench.control import readings

    c = harness.cell(name)
    with redirect_stdout(io.StringIO()):
        row = next(readings(c, [SEED], 3.0, "control"))
    ok, checks = check.judge(row["numbers"], c.spec["limits"], row["failed"], row["attempted"])
    assert not ok, checks
