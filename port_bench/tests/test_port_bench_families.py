"""Detector families (``port_bench/families/<family>.py``) and the weights
they resolve: each cell's costs as the families count them, pinned to the
integers the harness counted before families were files of their own; the
YOLO11-pose family's per-tile reference against the call it replaced; the
error for a family that has no file; the seeded-weights route."""
import ast
import glob
import os

import numpy as np
import pytest
import torch

from port_bench import harness, inputs, weights
from port_bench.reference import sahi, yolo

# (model FLOPs, tile-gather bytes) of one image, as ``harness.image_costs``
# counted them when it called ``flops.yolo11_pose_flops`` itself
PINNED = {
    "x2plus_v2.single_rgb": (7150889133568, 53477376),
    "yolo11n.single_rgb": (46340672000, 24182784),
    "yolo11n.single_crowd": (46340672000, 24182784),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_image_costs_are_the_parents_integers(name):
    assert harness.image_costs(harness.cell(name)) == PINNED[name]


def _parents_params(path: str, device) -> dict:
    """The reference's weights as ``reference/yolo.load_npz`` read them."""
    out = {}
    with np.load(path) as flat:
        for key in flat.files:
            a = flat[key].astype(np.float32)
            if key.endswith("kernel") and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


@pytest.mark.parametrize("split,conf", [(1, 0.05), (2, 0.3)])
def test_the_yolo_familys_tiles_are_the_parents_tile_detections(split, conf):
    """On a seeded photo of 256x384 with six faces, whole or as two tiles of
    256x192, bitwise."""
    config = harness.cell("yolo11n.single_rgb").config
    rgb = inputs.photo(2**33 + 11, 0, (256, 384), 6, (50, 100))
    canvas = torch.from_numpy(rgb).permute(2, 0, 1).float() / 255.0
    tiles = torch.stack(canvas.chunk(split, dim=2))
    got = harness.family("yolo11-pose").reference(config, harness.ROOT, "cpu")(tiles, conf)
    net = yolo.Yolo(_parents_params(os.path.join(harness.ROOT, config["detector"]["weights"]), "cpu"))
    want = sahi.tile_detections(net, yolo.decode, tiles, conf)
    assert len(got) == len(want) == split
    assert sum(len(w["scores"]) for w in want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"boxes", "scores", "kpts"}
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_an_unknown_family_names_the_file_it_looked_for():
    with pytest.raises(FileNotFoundError, match=r"port_bench/families/no-such-family\.py"):
        harness.family("no-such-family")


def test_the_yolo_family_refuses_seeded_weights():
    config = harness.cell("yolo11n.single_rgb").config
    config["detector"]["weights"] = {"seed": 3}
    with pytest.raises(ValueError, match="seed"):
        harness.family("yolo11-pose").reference(config, harness.ROOT, "cpu")


SHAPES = {"params/stem/conv/kernel": (3, 3, 3, 8), "params/stem/bn/scale": (8,), "batch_stats/stem/bn/var": (8,),
          "params/head/bias": (4,)}


def _draw(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(SHAPES[k]) for k in sorted(SHAPES)}


def test_seeded_weights_reach_the_program_and_the_reference_alike(tmp_path):
    from facedet_tpu_torch.models.from_jax import load_params_npz

    spec = {"seed": 2**33 + 3}
    path = weights.path(spec, str(tmp_path), _draw)
    assert path.startswith(str(tmp_path / "build")) and path.endswith(".npz")
    ref = weights.arrays(spec, str(tmp_path), _draw)
    assert set(ref) == set(SHAPES) and all(a.dtype == np.float32 for a in ref.values())
    # the program's public loader reads the very arrays the reference takes
    tree = load_params_npz(path)
    for key, a in ref.items():
        node = tree
        for part in key.split("/"):
            node = node[part]
        assert node.dtype == a.dtype and np.array_equal(node, a), key
    # the reference's tensors are those arrays, conv kernels as OIHW
    kernel = weights.tensors(ref, "cpu")["params/stem/conv/kernel"]
    assert torch.equal(kernel, torch.from_numpy(ref["params/stem/conv/kernel"].transpose(3, 2, 0, 1)))
    # drawn once: a second run finds the file; another seed writes another
    stamp = os.stat(path).st_mtime_ns
    assert weights.path(spec, str(tmp_path), _draw) == path and os.stat(path).st_mtime_ns == stamp
    other = weights.path({"seed": 4}, str(tmp_path), _draw)
    assert other != path and not np.array_equal(np.load(other)["params/head/bias"], ref["params/head/bias"])
    assert not list((tmp_path / "build" / "port_bench_weights").glob("*.part"))


def test_a_path_is_read_as_data():
    rel = os.path.join("facedet_tpu", "eval", "assets", "yolo11n_golden.npz")
    assert weights.path(rel, harness.ROOT) == os.path.join(harness.ROOT, rel)
    got = weights.load_npz(os.path.join(harness.ROOT, rel), "cpu")
    want = _parents_params(os.path.join(harness.ROOT, rel), "cpu")
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


PROGRAM = {"facedet_tpu_torch"}
FORBIDDEN = {"jax", "jaxlib", "flax", "facedet_tpu"}


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(harness.HERE, "families", "*.py"))),
                         ids=os.path.basename)
def test_a_family_imports_the_program_only_to_build_it(path):
    """The reference and the FLOP count of a family import nothing of the
    program: only ``program`` does, when it is called."""
    tree = ast.parse(open(path).read())
    names = {f.name for f in tree.body if isinstance(f, ast.FunctionDef)}
    assert {"program", "reference", "flops"} <= names
    for node in tree.body:
        inside_program = isinstance(node, ast.FunctionDef) and node.name == "program"
        for sub in ast.walk(node):
            if isinstance(sub, ast.Import):
                tops = {a.name.split(".")[0] for a in sub.names}
            elif isinstance(sub, ast.ImportFrom) and sub.level == 0:
                tops = {sub.module.split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN, (path, tops)
            assert inside_program or not tops & PROGRAM, (path, node.name if hasattr(node, "name") else node)
