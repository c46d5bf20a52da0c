"""The harness: finds a cell's files by name, runs it, reads its metrics and
judges its answers.

Layout under ``port_bench/`` (each item a file of its own, so a later change
adds a cell, a mix, a configuration, an entry or a metric by adding files):

  workloads/<cell>.json   the cell: configuration, mix, entry driver and its
                          settings, traced-window size, limits of the check
  configs/<config>.json   the configuration: weights, precision, slicing;
                          ``detector.family`` names its family file
  families/<family>.py    a detector family: ``program(config, device,
                          int8=False)`` the port's ``DetectionModel`` (``int8``
                          the program's own int8 path, the check's control);
                          ``reference(config, root, device)`` the plain
                          reference's per-tile function, float32 tiles
                          [B, 3, h, w] and ``conf`` in, per tile numpy
                          {boxes, scores, kpts} in tile pixels out, after the
                          family's own post-processing; ``flops(h, w, det)``
                          the model FLOPs of one forward at h x w
  traffic/<mix>.json      the mix, read by ``traffic.make``
  drivers/<entry>.py      drives one entry of the program (``Driver``)
  metrics/<metric>.py     reads one metric (``read(ctx)``; the file of the
                          whole name first, else of the part before its
                          first dot); ``None`` leaves the metric out
  reference/              the plain reference the answers are judged by

A configuration's ``detector.weights`` is the path of an ``.npz`` under the
repository or ``{"seed": N}``; the family alone resolves it
(``weights.py``): it draws float32 arrays from N, the program loads them
through its public loader from an ``.npz`` written under ``build/``, and the
reference takes the same arrays. The harness reads neither form.

Which metrics a cell reports is ``BENCHMARK.json``'s: the end-to-end ones
that list the cell (or list no cells) and the per-layer ones that list it
(or, listing none, move an end-to-end metric the cell reports).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "facedet_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``port_bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    for candidate in (name, name.split(".", 1)[0]):
        if os.path.exists(os.path.join(HERE, "metrics", f"{candidate}.py")):
            return load_module("metrics", candidate).read
    raise FileNotFoundError(f"no reader for metric {name!r} under port_bench/metrics/")


def family(name: str):
    """``port_bench/families/<name>.py``, the detector family a
    configuration's ``detector.family`` names."""
    path = os.path.join(HERE, "families", f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no detector family {name!r}: {os.path.relpath(path, ROOT)} does not exist")
    return load_module("families", name)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict  # workloads/<cell>.json
    config: dict
    mix: dict
    end_to_end: list  # BENCHMARK.json entries
    per_layer: list


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    spec = load_json("workloads", name)
    lists = lambda m: "workloads" not in m or name in m["workloads"]  # noqa: E731
    e2e = [m for m in bench["end_to_end"] if lists(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name, spec, load_json("configs", entry["config"]), load_json("traffic", entry["traffic"]),
                e2e, per_layer)


@dataclasses.dataclass
class Context:
    """What a metric reader may read."""

    cell: Cell
    setup_s: float | None = None
    window_s: float | None = None  # the measured window's length
    images: int = 0  # images answered inside the window
    latencies_s: list = dataclasses.field(default_factory=list)  # per request, call to result on the host
    durations: list = dataclasses.field(default_factory=list)  # the program's durations_in_seconds per request
    trace: object = None  # trace.Trace of the traced window
    plain_s: float | None = None  # host seconds of the traced window's requests run untraced before it
    plain_images: int = 0  # images those requests answered
    flops_per_image: float = 0.0
    gather_bytes_per_image: float = 0.0


def read_metrics(ctx: Context, entries: list) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def image_costs(c: Cell) -> tuple[float, float]:
    """(model FLOPs, tile-gather bytes) one image of the cell needs: the
    detector on each tile and on the letterboxed standard pass, the
    enhancer on the image's own pixels; the gather reads the windows'
    union of the canvas once and writes the tiles once, in the canvas's
    dtype."""
    from port_bench import bytes as nbytes
    from port_bench import flops
    from port_bench.reference import sahi

    det, s = c.config["detector"], c.config["slicing"]
    h, w = c.mix["height"], c.mix["width"]
    total = 0.0
    if "enhancer" in c.config:
        enh = c.config["enhancer"]
        total += flops.rrdb_flops(h, w, enh["scale"], enh["num_feat"], enh["num_grow_ch"], enh["num_block"])
        h, w = h * enh["outscale"], w * enh["outscale"]
    sh, sw = sahi.fixed_grid_slices(h, w) if s.get("policy") == "fixed_grid" else (s["slice"], s["slice"])
    offsets, _, canvas = sahi.slice_grid(h, w, sh, sw, s["overlap"])
    f = family(det["family"]).flops
    total += len(offsets) * f(sh, sw, det) + f(det["image_size"], det["image_size"], det)
    itemsize = 2 if det["dtype"] == "bfloat16" else 4
    return total, nbytes.gather_bytes(canvas, offsets, sh, sw, 3, itemsize)
