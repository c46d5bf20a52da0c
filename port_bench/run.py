"""Run one cell of the benchmark once, on the card, and print its result.

    python port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. In order: the cell's files, the inputs from
``--seed``, the weights and a warm-up of the cell's own shapes (the set-up),
then ``--seconds`` of measured requests (``--trace 0``: the end-to-end
metrics) or the cell's ``trace_requests`` twice, on the host clock and then
in one traced window (``--trace 1``: the per-layer metrics and a
breakdown). Then, with the program's state
freed, the plain reference recomputes the answer of every photo served and
every answer is judged (``check.py``). The numbers compared, each beside its
limit, are the last lines on standard error and the last key of the result,
which is the last line on standard output.

Exits non-zero and prints no result without enough CUDA devices, or when a
module of JAX or of the JAX package ``facedet_tpu`` is loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import harness  # noqa: E402

# build and kernel caches at fixed paths inside the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(harness.ROOT, "build", _dir)
os.environ.setdefault("USE_FLAX", "0")


def judge_answers(cell: harness.Cell, ref, items: list, win):
    """The ``check.Tally`` of a window's answers (and enhanced images)
    against the reference's answer for each photo served, computed once per
    photo."""
    from port_bench import check

    fetch = cell.spec["entry"].get("fetch_capacity") or 0
    want = {p: getattr(ref, cell.spec["reference"])(items[p], fetch) for p in sorted({p for p, _ in win.answers})}
    tally = check.Tally()
    for p, got in win.answers:
        if got is not None:
            tally.detections(got, want[p])
    for p, image in win.enhanced.items():
        tally.image(image, want[p]["image"])
    return tally


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device="cuda", t_start: float = T_START):
    """(result dict, numbers compared as text lines); ``device="cpu"`` runs
    it on the CPU for the tests (no device metric is then a device's)."""
    import torch

    from port_bench import check, traffic
    from port_bench import trace as tracing
    from port_bench.reference.expected import Reference

    cuda = torch.device(device).type == "cuda"
    items = traffic.make(cell.mix, seed)
    drv = harness.load_module("drivers", cell.spec["driver"]).Driver(cell, device)
    drv.load(items, seed)
    drv.warm()
    ctx = harness.Context(cell)
    ctx.flops_per_image, ctx.gather_bytes_per_image = harness.image_costs(cell)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if trace:
        # the same requests untimed by the profiler first: the host clock of
        # the cell's own load, which the profiler stretches
        t0 = time.perf_counter()
        ctx.plain_images = drv.requests(cell.spec["trace_requests"]).images
        ctx.plain_s = time.perf_counter() - t0
        ctx.trace, win = tracing.traced(lambda: drv.requests(cell.spec["trace_requests"]), torch.device(device))
        ctx.images, ctx.durations = win.images, win.durations
        metrics = harness.read_metrics(ctx, cell.per_layer)
    else:
        win = drv.window(seconds)
        ctx.setup_s = win.t_open - t_start
        ctx.window_s, ctx.images, ctx.latencies_s, ctx.durations = win.window_s, win.images, win.latencies_s, win.durations
        metrics = harness.read_metrics(ctx, cell.end_to_end)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    if trace:
        dev["busy_s"], dev["window_s"] = ctx.trace.busy_s, ctx.trace.window_s
        stretch = f"traced window {ctx.trace.window_s!r} s, the same requests untraced {ctx.plain_s!r} s"

    # the reference runs after the program's state is freed, so it sets no peak
    del drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = judge_answers(cell, Reference(cell.config, harness.ROOT, device), items, win).numbers()
    correct, checks = check.judge(numbers, cell.spec["limits"], win.failed, win.attempted)
    result = {"correct": correct, "attempted": win.attempted, "failed": win.failed, "metrics": metrics,
              "device": dev}
    if trace:
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = checks
    lines = [stretch] if trace else []
    if win.error:
        lines.append(f"first error: {win.error}")
    lines.append(f"failed {win.failed} of {win.attempted} attempted")
    lines += [f"{'ok  ' if c['value'] is not None and c['value'] <= c['limit'] else 'FAIL'} {k} {c['value']!r} "
              f"limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = harness.benchmark()
    cell = harness.cell(args.workload, bench)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, lines = run(cell, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"port_bench: modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
