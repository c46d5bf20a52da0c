"""The readings that set a cell's limits: the program's numbers over many
seeds and the control's, each over a window of the cell's own load.

    python port_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 5 [--mode program|control|both]

The control is one precision below the configuration's bfloat16: the
program with its own int8 path switched on (its family's ``program(...,
int8=True)``) and, for a cell with an enhancer, the reference's RRDBNet
computed in int8 (``reference/rrdb.int8_conv``) in the enhancer's place.
One line of JSON per mode and seed. The benchmark's own runs never run this.
"""
from __future__ import annotations

import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import harness, traffic  # noqa: E402
from port_bench.run import judge_answers  # noqa: E402


def readings(cell: harness.Cell, seeds, seconds: float, mode: str, device="cuda"):
    """Yields {mode, seed, numbers, failed, attempted, images} per seed."""
    import torch

    from port_bench import weights
    from port_bench.reference import rrdb
    from port_bench.reference.expected import Reference

    ref = Reference(cell.config, harness.ROOT, device)
    module = harness.load_module("drivers", cell.spec["driver"])
    kwargs = {}
    if mode == "control" and "enhancer" in cell.config:
        e = cell.config["enhancer"]
        net = rrdb.RRDB(weights.load_npz(os.path.join(harness.ROOT, e["weights"]), device), e["scale"], e["num_block"])
        net.conv = rrdb.int8_conv
        kwargs["enhancer"] = rrdb.Enhancer(net, e["outscale"], e["tile"], e["tile_pad"], device)
    drv = module.Driver(cell, device, int8=mode == "control", **kwargs)
    for k, seed in enumerate(seeds):
        items = traffic.make(cell.mix, seed)
        drv.load(items, seed)
        if k == 0:
            drv.warm()
        win = drv.window(seconds)
        tally = judge_answers(cell, ref, items, win)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        yield {"mode": mode, "seed": seed, "numbers": tally.numbers(), "spread": tally.spread(), "failed": win.failed,
               "attempted": win.attempted, "images": win.images, "confident": tally.confident, "error": win.error}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--mode", choices=("program", "control", "both"), default="both")
    args = ap.parse_args(argv)
    cell = harness.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for mode in ("program", "control") if args.mode == "both" else (args.mode,):
        t0 = time.perf_counter()
        for row in readings(cell, seeds, args.seconds, mode):
            print(json.dumps(row), flush=True)
        print(f"{mode}: {len(seeds)} seeds in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
