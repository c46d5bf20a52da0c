"""Where the card waits, by stage of the program: one cell's traced window,
taken as ``run.py --trace 1`` takes it, with its device-idle time split over
the program's spans (``spans.report``).

    python port_bench/stages.py --workload <cell> --seed <n>

From the root of a checkout, on the card. Prints one JSON line: device-idle
ms per request by stage path, the idle ms inside no span and the share
inside spans, the clock's error, spans per request, fixpoint rounds by the
stage that runs them, and the median host ms of a request untraced and
traced. Judges no answer: ``run.py`` does that.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import harness  # noqa: E402

for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(harness.ROOT, "build", _dir)
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch

    from port_bench import spans, traffic
    from port_bench import trace as tracing

    if not torch.cuda.is_available():
        print("port_bench stages: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    n = cell.spec["trace_requests"]
    drv = harness.load_module("drivers", cell.spec["driver"]).Driver(cell, "cuda")
    drv.load(traffic.make(cell.mix, args.seed), args.seed)
    drv.warm()
    drv.requests(n)  # the same requests untraced first, as run.py runs them
    ctx = harness.Context(cell)
    ctx.trace, win = tracing.traced(lambda: drv.requests(n), torch.device("cuda"))
    ctx.images = win.images
    print(json.dumps({"workload": args.workload, "seed": args.seed, **spans.report(ctx)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
