"""Evaluation results page.

Reference: pipeline_v4_yolo/pages/2_Evaluation.py — displays the 4
pre-computed evaluation charts (baseline / SAHI / enhance / full, :10-28)
behind a simulated spinner (:63-66). Here the page renders whatever artifacts
the evaluators actually produced (PR curves from eval/widerface_official.py,
the dual-eval bar chart, tuner JSON) — real results, no simulation.

Counterpart of facedet_tpu/apps/streamlit_eval_page.py, copied.
``run_page`` needs streamlit, which raises ImportError where it is not
installed.
"""
from __future__ import annotations

import json
import os

__all__ = ["EVAL_ARTIFACTS", "collect_artifacts", "run_page"]

EVAL_ARTIFACTS = [
    ("PR curves (official protocol)", "pr_curve_*.png"),
    ("Dual evaluation chart", "dual_eval_chart.png"),
]


def collect_artifacts(output_dir: str = "output") -> dict:
    """Gather evaluator outputs for display."""
    import glob

    found: dict = {"images": [], "json": {}}
    for _label, pattern in EVAL_ARTIFACTS:
        found["images"].extend(sorted(glob.glob(os.path.join(output_dir, pattern))))
    for name in ("official_eval_results.json", "dual_eval_results.json",
                 "sahi_tuning_complete_results.json", "best_sahi_config.json"):
        path = os.path.join(output_dir, name)
        if os.path.exists(path):
            with open(path) as f:
                found["json"][name] = json.load(f)
    return found


def run_page(output_dir: str = "output"):  # pragma: no cover - needs streamlit
    import streamlit as st

    st.title("Evaluation Results")
    found = collect_artifacts(output_dir)
    if not found["images"] and not found["json"]:
        st.info(
            "No evaluation artifacts found. Run facedet_tpu_torch.apps.eval_official "
            "or eval_dual_cli first."
        )
        return
    for img in found["images"]:
        st.subheader(os.path.basename(img))
        st.image(img)
    for name, data in found["json"].items():
        with st.expander(name):
            st.json(data)


if __name__ == "__main__":
    try:
        import streamlit  # noqa: F401

        run_page()
    except ImportError:
        print(json.dumps(collect_artifacts(), default=str, indent=2))
