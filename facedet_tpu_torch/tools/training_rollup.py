"""Training-run rollup: scan run directories, pick best epochs, emit CSV.

A host-side copy of facedet_tpu/tools/training_rollup.py: it scans the
trainer output dirs (results.csv + config.json or args.yaml), picks the best
epoch by an mAP-style column (ultralytics' names or the trainers') or else
the lowest loss, and writes ``summary_box_metrics.csv``.

Run: python -m facedet_tpu_torch.tools.training_rollup --runs <dir>
"""
from __future__ import annotations

import csv
import json
import os
from typing import Optional

BEST_METRIC_CANDIDATES = (
    "metrics/mAP50-95(B)",
    "map",
    "map50",
    "val_loss",
    "train_loss",
)


def _read_results_csv(path: str) -> list[dict]:
    with open(path) as f:
        reader = csv.DictReader(f)
        return [
            {k.strip(): v.strip() for k, v in row.items() if k is not None}
            for row in reader
        ]


def best_epoch(rows: list[dict]) -> Optional[dict]:
    """Best row: max mAP-style metric if present, else min loss."""
    if not rows:
        return None
    for metric in BEST_METRIC_CANDIDATES:
        if metric in rows[0]:
            maximize = "loss" not in metric
            key = lambda r: float(r[metric])
            return (max if maximize else min)(rows, key=key) | {"best_metric": metric}
    return rows[-1]


def scan_runs(runs_root: str) -> list[dict]:
    """Walk run dirs containing results.csv; attach config/args when present."""
    summaries = []
    for dirpath, _dirnames, filenames in os.walk(runs_root):
        if "results.csv" not in filenames:
            continue
        rows = _read_results_csv(os.path.join(dirpath, "results.csv"))
        best = best_epoch(rows)
        if best is None:
            continue
        entry = {"run": os.path.relpath(dirpath, runs_root), **best}
        for cfg_name in ("args.yaml", "config.json"):
            p = os.path.join(dirpath, cfg_name)
            if os.path.exists(p):
                entry["config_file"] = cfg_name
                if cfg_name.endswith(".json"):
                    with open(p) as f:
                        cfg = json.load(f)
                    for k in ("imgsz", "batch", "lr", "epochs"):
                        if k in cfg:
                            entry[k] = cfg[k]
        summaries.append(entry)
    return summaries


def write_summary(
    runs_root: str, output_csv: str = "summary_box_metrics.csv"
) -> list[dict]:
    """scan + emit the summary CSV (check_best_pt.py:104-107)."""
    summaries = scan_runs(runs_root)
    if summaries:
        keys = sorted({k for s in summaries for k in s})
        with open(output_csv, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            writer.writerows(summaries)
    return summaries


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="runs")
    ap.add_argument("--output", default="summary_box_metrics.csv")
    args = ap.parse_args()
    rows = write_summary(args.runs, args.output)
    for r in rows:
        print(r)
