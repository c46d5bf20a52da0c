"""Tests of the benchmark harness: ``python -m pytest port_bench/tests`` from
the root of the repository. Tests marked ``cuda`` need the card and skip
where torch sees none."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")
