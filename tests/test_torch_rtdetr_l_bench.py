"""The benchmark's RT-DETR-l family (port_bench/families/rtdetr.py), its
cell ``rtdetr-l.single_rgb`` and its metric reader, on the CPU: the harness
finds the family by name, its seeded weights reach the program and the plain
reference alike, the layout keeps to the benchmark's forms, the FLOP count
matches a count of the reference's own products, the cells that were there
cost what they cost before, and a narrow RT-DETR-l cell runs through
``run.run`` end to end and is judged correct."""
import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from port_bench import harness, rtdetr_flops, spans, weights  # noqa: E402
from port_bench.reference import rtdetr_l as plain  # noqa: E402
from port_bench.tests import test_port_bench_families as families_tests  # noqa: E402
from port_bench.tests import test_port_bench_layout as layout_tests  # noqa: E402

CELL = "rtdetr-l.single_rgb"
TINY = dict(stem=(8, 12), stage_mid=(8, 12, 16, 24), stage_out=(16, 32, 48, 64), block_layers=2, hidden_dim=32,
            ffn_dim=64, repc3_depth=1, num_decoder_layers=2, num_heads=4)

# (model FLOPs, tile-gather bytes) of one image: the three cells that were
# there, as the harness counted them before this family, and the new cell (six
# tiles of 640 and the standard pass, 109,239,449,600 FLOPs a forward)
PINNED = {
    "x2plus_v2.single_rgb": (7150889133568, 53477376),
    "yolo11n.single_rgb": (46340672000, 24182784),
    "yolo11n.single_crowd": (46340672000, 24182784),
    CELL: (7 * 109239449600, 24182784),
}


def test_the_harness_finds_the_family_and_its_cell():
    fam = harness.family("rtdetr")
    assert all(callable(getattr(fam, f)) for f in ("draw", "program", "reference", "flops"))
    cell = harness.cell(CELL)
    assert cell.config["detector"]["family"] == "rtdetr" and cell.config["detector"]["variant"] == "rtdetr-l-hgnetv2"
    assert cell.spec["driver"] == "single" and cell.spec["reference"] == "sliced" and cell.spec["trace_requests"] == 20
    assert cell.mix == harness.cell("yolo11n.single_rgb").mix
    assert cell.config["slicing"] == harness.cell("yolo11n.single_rgb").config["slicing"]
    names = {m["name"] for m in cell.per_layer}
    assert "deform_ns_per_sample.rtdetr" in names and "forward_graph_share.latency" in names
    assert {m["name"] for m in cell.end_to_end} == {"image_ms_p50", "image_ms_p95", "setup_s"}


def test_the_family_imports_the_program_only_to_build_it():
    families_tests.test_a_family_imports_the_program_only_to_build_it(
        os.path.join(harness.HERE, "families", "rtdetr.py"))


def test_benchmark_json_keeps_to_the_forms():
    layout_tests.test_benchmark_json_keeps_to_the_forms()
    bench = harness.benchmark()
    config = next(c for c in bench["configs"] if c["name"] == "rtdetr-l-face")
    assert config["reduced"] == [] and config["file"] == "port_bench/configs/rtdetr-l-face.json"
    assert any(w["name"] == CELL and w["chips"] == 1 for w in bench["workloads"])


@pytest.mark.parametrize("name", sorted(PINNED))
def test_image_costs(name):
    assert harness.image_costs(harness.cell(name)) == PINNED[name]


@pytest.mark.parametrize("split,conf", [(1, 0.05), (2, 0.3)])
def test_the_yolo_reference_answers_as_before(split, conf):
    families_tests.test_the_yolo_familys_tiles_are_the_parents_tile_detections(split, conf)


def test_seeded_weights_reach_the_program_and_the_reference_alike(tmp_path):
    """The configuration's seed, through ``weights.path``, to the ``.npz``
    the program loads; the reference's arrays are the same ones, under
    Ultralytics' names and in the published layout's shapes."""
    from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel

    fam = harness.family("rtdetr")
    spec = harness.cell(CELL).config["detector"]["weights"]
    path = weights.path(spec, str(tmp_path), fam.draw)
    ref = weights.arrays(spec, str(tmp_path), fam.draw)
    assert {k: v.shape for k, v in ref.items()} == plain.state_shapes()
    with np.load(path) as flat:
        assert set(flat.files) == set(ref) and all(np.array_equal(flat[k], ref[k]) for k in ref)
    det = RtDetrDetectionModel(model_path=path, variant="rtdetr-l-hgnetv2", dtype="float32", device="cpu")
    state = det.model.state_dict()
    assert all(np.array_equal(state[k].numpy(), ref[k]) for k in ref)
    tensors = weights.tensors(ref, "cpu")  # Ultralytics' OIHW kernels, untransposed
    assert torch.equal(tensors["model.0.stem1.conv.weight"], torch.from_numpy(ref["model.0.stem1.conv.weight"]))
    # the statistics keep every normalised activation of order one
    assert all(np.isfinite(v).all() and (v > 0).all() for k, v in ref.items() if k.endswith("running_var"))


@pytest.mark.parametrize("hw", [(256, 256), (192, 320)])
def test_flops_match_a_count_of_the_reference(hw):
    """Convolutions, linears and attention products as torch's FLOP counter
    counts them over the reference's forward; the sampling's
    multiply-adds (not counted by torch) from the shapes."""
    shapes = plain.state_shapes(**TINY)
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy((0.1 * rng.standard_normal(s)).astype(np.float32)) for k, s in shapes.items()}
    for k in params:
        if k.endswith("running_var"):
            params[k] = params[k].abs() + 1.0
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        plain.RtDetrL(params, num_heads=4, num_queries=30)(torch.rand(1, 3, *hw))
    parts = rtdetr_flops.rtdetr_l_parts(*hw, num_queries=30, **TINY)
    assert parts["conv"] + parts["linear"] + parts["attention"] == counter.get_total_flops()
    assert parts["sampling"] == 2 * 30 * 4 * 3 * 4 * (32 // 4) * 5 * 2


def test_flops_at_640_are_the_papers():
    # arXiv:2304.08069 lists RT-DETR-L at 110 GFLOPs (80 classes)
    assert 108e9 < rtdetr_flops.rtdetr_l_flops(640, 640, 80) < 111e9
    assert rtdetr_flops.rtdetr_l_flops(640, 640) == 109239449600


class _Trace:
    def __init__(self, ops):
        self.ops = ops

    def seconds_by_name(self, match):
        return sum(e - s for name, s, e in self.ops if match in name.lower())


def test_deform_ns_per_sample_reads_kernels_over_counted_samples(monkeypatch):
    from facedet_tpu_torch.utils.profiling import SpanRecorder

    reader = harness.reader("deform_ns_per_sample.rtdetr")
    cell = harness.cell(CELL)
    ctx = harness.Context(cell)
    assert reader(ctx) is None  # no trace
    rec = SpanRecorder()
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    for _ in range(cell.spec["trace_requests"]):
        with rec.span("request", rec.new_request()) as root:
            root.profiled = True
            for n in (600, 100):
                with rec.span("detector") as s:
                    s.add("deform_samples", n)
    ctx.trace = _Trace([("void at::native::grid_sampler_2d_kernel<float, int>", 0.0, 7e-6), ("gemm", 0.0, 1.0),
                        ("grid_sampler_2d_kernel", 1.0, 1.000007)])
    assert reader(ctx) == pytest.approx(1e9 * 14e-6 / (20 * 700))
    ctx.trace = _Trace([("gemm", 0.0, 1.0)])
    assert reader(ctx) is None  # no sampling kernel: a program without the decoder


FAMILY = '''
import importlib.util
import os

from port_bench.reference import rtdetr_l

_spec = importlib.util.spec_from_file_location("rtdetr_base", os.path.join(os.path.dirname(__file__), "rtdetr.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)
TINY = {tiny!r}


def draw(seed):
    return base.drawn(seed, rtdetr_l.state_shapes(**TINY), heads=4, score_bias=-0.5)


base.draw = draw
program, reference, flops = base.program, base.reference, base.flops
'''

RUN = '''
import json, sys, time
import torch
from port_bench import harness
from port_bench.run import run

torch.set_num_threads(4)
result, lines = run(harness.cell("tiny.cell"), 2**33 + 5, 0.5, False, device="cpu", t_start=time.perf_counter())
print("\\n".join(lines), file=sys.stderr)
print(json.dumps(result))
'''


def test_a_narrow_rtdetr_cell_runs_and_is_correct(tmp_path):
    """The family with the narrow layout (its draw over the tiny shapes, the
    configuration naming ``rtdetr-l-hgnetv2-tiny``), float32, through
    ``run.run`` on the CPU with the harness's own reference: correct, no
    request failed, and the weights drawn once."""
    pb = tmp_path / "port_bench"
    shutil.copytree(harness.HERE, pb, ignore=shutil.ignore_patterns("__pycache__"))
    (pb / "families" / "rtdetr-tiny.py").write_text(FAMILY.format(tiny=TINY))
    config = json.loads((pb / "configs" / "rtdetr-l-face.json").read_text())
    config.update(num_heads=4, num_queries=30)
    config["detector"].update(family="rtdetr-tiny", variant="rtdetr-l-hgnetv2-tiny", dtype="float32", image_size=256)
    config["slicing"]["slice"] = 256
    (pb / "configs" / "tiny_cfg.json").write_text(json.dumps(config))
    (pb / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"photos": 2, "height": 320, "width": 480, "faces": 4, "face_px": [40, 80], "format": "rgb"}))
    (pb / "workloads" / "tiny.cell.json").write_text(json.dumps(
        {"driver": "single", "reference": "sliced", "entry": {}, "trace_requests": 2,
         "limits": {"gap_p50": 0.001, "gap_p90": 0.001, "worst_answer_p50": 0.001}}))
    bench = harness.benchmark()
    bench["configs"].append({"name": "tiny_cfg", "source": "https://example.org/tiny",
                             "file": "port_bench/configs/tiny_cfg.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny_cfg", "traffic": "tiny_mix", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "tiny_run.py").write_text(RUN)
    out = subprocess.run([sys.executable, "tiny_run.py"], cwd=tmp_path, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT])))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0, (result, out.stderr[-2000:])
    assert all(c["value"] is not None for c in result["checks"].values())
    assert len(glob.glob(str(tmp_path / "build" / "port_bench_weights" / "*.npz"))) == 1
