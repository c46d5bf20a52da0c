"""The layout is driven by data: a new cell, configuration, mix, entry
driver and metric are files that the harness finds by name, with no edit to
a file that is there; and ``BENCHMARK.json`` keeps to the contract's forms."""
import filecmp
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

from port_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keeps_to_the_forms():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert bench["paths"] == ["port_bench"] and len(bench["command"]) <= 32
    assert all(LINE.match(w) for w in bench["command"])
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("port_bench/") and os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["config"] in names and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        names.append(w["name"])
    e2e = {}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = m
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) < 64 * 1024
    for w in bench["workloads"]:
        c = harness.cell(w["name"], bench)
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
        for m in c.end_to_end + c.per_layer:
            harness.reader(m["name"])
        assert os.path.exists(os.path.join(harness.HERE, "drivers", c.spec["driver"] + ".py"))
        assert c.spec["limits"]


FAKE_DRIVER = '''
import numpy as np
import time
from port_bench.window import Window

ANSWER = {"boxes": np.array([[2.0, 2.0, 20.0, 24.0]], np.float32), "scores": np.array([0.9], np.float32),
          "kpts": np.zeros((1, 5, 3), np.float32)}


class Driver:
    def __init__(self, cell, device, int8=False):
        self.cell = cell

    def load(self, items, seed):
        self.items = items

    def warm(self):
        pass

    def requests(self, count):
        return Window(answers=[(k % len(self.items), dict(ANSWER)) for k in range(count)], attempted=count,
                      failed=0, images=count)

    def window(self, seconds):
        win = self.requests(5)
        win.t_open, win.window_s, win.latencies_s = time.perf_counter(), 0.5, [0.1] * 5
        return win
'''

FAKE_RUN = '''
import json, sys, time
sys.path.insert(0, ".")
from port_bench import harness
import port_bench.reference.expected as expected
from port_bench.run import run


class FakeReference:
    def __init__(self, *args):
        pass

    def sliced(self, item, fetch=0):
        from port_bench.drivers_fake_answer import ANSWER
        return ANSWER


expected.Reference = FakeReference
import port_bench.run as R
R.Reference = FakeReference
result, lines = run(harness.cell("fake.cell"), 7, 0.5, False, device="cpu", t_start=time.perf_counter())
print(json.dumps(result))
'''


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_configuration_mix_driver_and_metric_are_found(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "port_bench")
    bench = harness.benchmark()
    pb = tmp_path / "port_bench"
    config = json.loads((pb / "configs" / "yolo11n-pose-face.json").read_text())
    (pb / "configs" / "fake_cfg.json").write_text(json.dumps(config))
    (pb / "traffic" / "fake_mix.json").write_text(json.dumps(
        {"photos": 2, "height": 64, "width": 96, "faces": 1, "face_px": [20, 30], "format": "rgb"}))
    (pb / "workloads" / "fake.cell.json").write_text(json.dumps(
        {"driver": "fake_cpu", "reference": "sliced", "entry": {}, "trace_requests": 4,
         "limits": {"gap_p90": 0.0, "worst_answer_p50": 0.0}}))
    (pb / "drivers" / "fake_cpu.py").write_text(FAKE_DRIVER)
    (pb / "drivers_fake_answer.py").write_text(FAKE_DRIVER)
    (pb / "metrics" / "answers_seen.py").write_text("def read(ctx):\n    return float(ctx.images)\n")
    bench["configs"].append({"name": "fake_cfg", "source": "https://example.org/fake", "file": "port_bench/configs/fake_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "fake.cell", "config": "fake_cfg", "traffic": "fake_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "answers_seen", "unit": "answers", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["fake.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "fake_run.py").write_text(FAKE_RUN)
    out = subprocess.run([sys.executable, "fake_run.py"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["answers_seen"]["value"] == 5.0
    assert set(result["metrics"]) == {"answers_seen", "setup_s"}
    after = _digest(tmp_path / "port_bench")
    assert all(after[k] == v for k, v in before.items())  # nothing that was there changed
    assert filecmp.cmp(tmp_path / "port_bench" / "run.py", os.path.join(harness.HERE, "run.py"), shallow=False)


# a detector family that no file of the harness names: the port's YOLO11-pose
# detector and the plain reference's forward over weights drawn from the
# configuration's seed, with the shapes of a YOLO11n-pose checkpoint
NEW_FAMILY = '''
import numpy as np

from port_bench import flops as counts
from port_bench import weights

SHAPES = {shapes!r}


def draw(seed):
    rng = np.random.default_rng(seed)
    out = {{}}
    for key in sorted(SHAPES):
        shape, leaf = SHAPES[key], key.rsplit("/", 1)[1]
        if leaf == "kernel":
            out[key] = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif leaf in ("var", "scale"):
            out[key] = rng.uniform(0.5, 1.5, shape)
        else:
            out[key] = 0.1 * rng.standard_normal(shape)
    return out


def program(config, device, int8=False):
    from facedet_tpu_torch import YoloV11PoseDetectionModel

    from port_bench.harness import ROOT

    d = config["detector"]
    return YoloV11PoseDetectionModel(model_path=weights.path(d["weights"], ROOT, draw), scale="n",
                                     image_size=d["image_size"], dtype=d["dtype"], device=device,
                                     confidence_threshold=d["confidence_threshold"])


def reference(config, root, device):
    from port_bench.reference import sahi, yolo

    net = yolo.Yolo(weights.tensors(weights.arrays(config["detector"]["weights"], root, draw), device))
    return lambda tiles, conf: sahi.tile_detections(net, yolo.decode, tiles, conf)


def flops(h, w, det):
    return counts.yolo11_pose_flops(h, w, "n")
'''

NEW_FAMILY_RUN = '''
import json, sys, time
import torch
from port_bench import harness
from port_bench.run import run

torch.set_num_threads(4)
result, lines = run(harness.cell("fresh.cell"), 2**33 + 7, 0.5, False, device="cpu", t_start=time.perf_counter())
print("\\n".join(lines), file=sys.stderr)
print(json.dumps(result))
'''


def test_a_new_detector_family_with_seeded_weights_is_found(tmp_path):
    """A configuration whose ``detector.family`` no file of the harness names,
    its family file with weights from ``{"seed": N}``, and a cell: run on the
    CPU through ``run.run`` with the harness's own reference, ``correct``,
    and nothing that was there changed."""
    import numpy as np

    pb = tmp_path / "port_bench"
    shutil.copytree(harness.HERE, pb, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(pb)
    family = "fresh-" + hashlib.sha256(str(tmp_path).encode()).hexdigest()[:8]
    for rel in before:
        if not rel.startswith("tests"):
            assert family not in (pb / rel).read_text(errors="ignore"), rel
    with np.load(os.path.join(harness.ROOT, "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")) as golden:
        shapes = {k: golden[k].shape for k in golden.files}
    (pb / "families" / f"{family}.py").write_text(NEW_FAMILY.format(shapes=shapes))
    detector = {"family": family, "weights": {"seed": 20240607}, "num_classes": 1, "num_keypoints": 5,
                "dtype": "float32", "image_size": 64, "confidence_threshold": 0.3}
    slicing = {"slice": 64, "overlap": 0.2, "standard_pass": True, "postprocess": "GREEDYNMM",
               "match_metric": "IOS", "match_threshold": 0.5}
    (pb / "configs" / "fresh_cfg.json").write_text(json.dumps({"detector": detector, "slicing": slicing}))
    (pb / "traffic" / "fresh_mix.json").write_text(json.dumps(
        {"photos": 2, "height": 96, "width": 128, "faces": 1, "face_px": [20, 30], "format": "rgb"}))
    limits = harness.cell("yolo11n.single_rgb").spec["limits"]
    (pb / "workloads" / "fresh.cell.json").write_text(json.dumps(
        {"driver": "single", "reference": "sliced", "entry": {}, "trace_requests": 2, "limits": limits}))
    bench = harness.benchmark()
    bench["configs"].append({"name": "fresh_cfg", "source": "https://example.org/fresh",
                             "file": "port_bench/configs/fresh_cfg.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "fresh.cell", "config": "fresh_cfg", "traffic": "fresh_mix", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "fresh_run.py").write_text(NEW_FAMILY_RUN)
    out = subprocess.run([sys.executable, "fresh_run.py"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), harness.ROOT])))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0, (result, out.stderr[-2000:])
    assert set(result["metrics"]) == {"setup_s"}
    drawn = list((tmp_path / "build" / "port_bench_weights").glob("*.npz"))
    assert len(drawn) == 1  # the program's file, drawn once
    after = _digest(pb)
    assert all(after[k] == v for k, v in before.items())  # nothing that was there changed
