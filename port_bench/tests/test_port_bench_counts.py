"""The FLOP and byte counts of ``flops.py`` and ``bytes.py``, from shapes,
against counts made another way: torch's FLOP counter over the frozen
reference forwards (two FLOPs per multiply-add of every convolution and
matrix product, as ``flops.py`` counts), and the gather's bytes summed tile
by tile and cell by cell of the canvas."""
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import bytes as nbytes
from port_bench import flops, harness, weights
from port_bench.reference import rrdb, sahi, yolo

ASSETS = os.path.join(harness.ROOT, "facedet_tpu", "eval", "assets")


def _counted(fn, *args) -> int:
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    return counter.get_total_flops()


@pytest.fixture(scope="module")
def yolo_ref():
    return yolo.Yolo(weights.load_npz(os.path.join(ASSETS, "yolo11n_golden.npz"), "cpu"))


@pytest.mark.parametrize("hw", [(640, 640), (512, 704), (320, 480)])
def test_yolo_flops_match_the_reference_forward(yolo_ref, hw):
    assert flops.yolo11_pose_flops(*hw) == _counted(yolo_ref, torch.zeros(1, 3, *hw))


def test_yolo_flops_at_640_are_yolo11n_pose_sized():
    # Ultralytics lists yolo11n-pose (17 keypoints, 1 class) at 7.6 GFLOP;
    # the face head's 5 keypoints make it a little smaller
    assert 6.0e9 < flops.yolo11_pose_flops(640, 640) < 7.6e9


@pytest.mark.parametrize("hw", [(32, 48), (64, 40)])
def test_rrdb_flops_match_the_reference_forward(hw):
    params = weights.load_npz(os.path.join(ASSETS, "rrdb_x2_golden.npz"), "cpu")
    net = rrdb.RRDB(params, 2, 23)
    assert flops.rrdb_flops(*hw) == _counted(net, torch.zeros(1, 3, *hw))


def test_rrdb_flops_of_the_v2_photo():
    # about 7 TFLOP for a 768x1024 photo (its body runs at 384x512)
    assert 6.5e12 < flops.rrdb_flops(768, 1024) < 7.5e12


def _covered(starts, size) -> int:
    """Length of the union of the intervals [start, start + size)."""
    return len(set().union(*(range(a, a + size) for a in starts)))


@pytest.mark.parametrize("hw,s", [((1024, 1536), (640, 640)), ((1536, 2048), (512, 704)), ((500, 900), (320, 320))])
def test_gather_bytes_against_a_count_by_axis(hw, s):
    # the windows form a grid, so their union is the product of the unions
    # of their rows and of their columns
    offsets, _, canvas = sahi.slice_grid(*hw, *s, 0.2)
    read = _covered({int(y) for y, _ in offsets}, s[0]) * _covered({int(x) for _, x in offsets}, s[1])
    written = len(offsets) * s[0] * s[1]
    assert nbytes.gather_bytes(canvas, offsets, *s, 3, 2) == (read + written) * 3 * 2


def test_gather_bytes_of_the_serving_image():
    offsets, _, canvas = sahi.slice_grid(1024, 1536, 640, 640, 0.2)
    assert len(offsets) == 6
    # the kernel table's bound: 16 images in 0.11550 ms at 3.35 TB/s
    assert abs(16 * nbytes.gather_bytes(canvas, offsets, 640, 640, 3, 2) / 3.35e12 * 1e3 - 0.11550) < 1e-5


# the cells' model FLOPs from the detector's per-forward count ``f`` at the
# cells' own tile shapes: the tiles, the letterboxed standard pass at 640²,
# the enhancer before them in v2
CASES = {
    "x2plus_v2.single_rgb": lambda f: flops.rrdb_flops(768, 1024) + 16 * f(512, 704) + f(640, 640),
    "yolo11n.single_rgb": lambda f: 7 * f(640, 640),
    "yolo11n.single_crowd": lambda f: 7 * f(640, 640),
}
# what the families of those cells count, written out
FAMILY_FLOPS = {"yolo11-pose": flops.yolo11_pose_flops}


@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark()["workloads"]])
def test_image_costs_of_each_cell(name):
    """Each cell's detector term is its own family's ``flops``."""
    c = harness.cell(name)
    det = c.config["detector"]
    own = harness.family(det["family"]).flops
    total, gathered = harness.image_costs(c)
    assert gathered > 0 and np.isfinite(gathered)
    assert total >= own(det["image_size"], det["image_size"], det) > 0
    if name in CASES:
        assert total == CASES[name](lambda h, w: own(h, w, det))
    if name in CASES and det["family"] in FAMILY_FLOPS:
        assert total == CASES[name](FAMILY_FLOPS[det["family"]])
