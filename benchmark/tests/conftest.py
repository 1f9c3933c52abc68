"""Shared fixtures of the benchmark's CPU tests.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
``tiny_root`` is a copy of the benchmark's data (``BENCHMARK.json``,
configurations, traffic, workloads, metric readers) whose traffic is cut
to 2 images of 64 x 64, so a whole run of a cell fits a CPU test; the
harness's code is the repository's own.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"batch": 2, "height": 64, "width": 64, "trace_units": 2}


@pytest.fixture
def tiny_root(tmp_path):
    (tmp_path / "benchmark").mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(ROOT / "benchmark" / d, tmp_path / "benchmark" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for path in (tmp_path / "benchmark" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(TINY)
        path.write_text(json.dumps(traffic))
    return tmp_path
