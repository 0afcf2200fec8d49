"""Fixtures of the benchmark's own tests: ``python -m pytest portbench/tests``.

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which skips them where there is none; run them on a
machine with a card with ``python -m pytest portbench/tests -m card``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

# the cells at a size a test run holds: pods per batch (nodes per fleet),
# batches per ring and instance types
SMALL = {"burst-50k": (600, 2, 60), "diverse-500": (120, 2, 40),
         "generic-500": (100, 2, 40), "consolidate-2000": (48, 2, 64)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures the port on the card")


def make_root(dest: Path, small: bool = True) -> Path:
    """A copy of ``BENCHMARK.json`` and the benchmark's data under
    ``dest``, its cells cut to ``SMALL`` when ``small``; returns the path
    of the copied ``BENCHMARK.json``."""
    for sub in ("configs", "traffic", "metrics", "kinds"):
        shutil.copytree(ROOT / "portbench" / sub, dest / "portbench" / sub)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    if small:
        doc = json.loads((dest / "BENCHMARK.json").read_text())
        for cell in doc["workloads"]:
            pods, ring, types = SMALL[cell["name"]]
            tpath = dest / "portbench" / "traffic" / f"{cell['traffic']}.json"
            traffic = json.loads(tpath.read_text())
            size = "nodes" if "nodes" in traffic else "pods"
            traffic.update({size: pods, "ring": ring, "sample": ring + 1})
            tpath.write_text(json.dumps(traffic))
            entry = next(c for c in doc["configs"] if c["name"] == cell["config"])
            cpath = dest / entry["file"]
            cfg = json.loads(cpath.read_text())
            cfg["catalog"]["types"] = types
            cpath.write_text(json.dumps(cfg))
    return dest / "BENCHMARK.json"


@pytest.fixture
def small_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture(params=["native", "device"])
def engine(request, monkeypatch):
    """The port's CPU engines: its routing at the defaults (the native C++
    engine), and its device path pinned on the CPU."""
    if request.param == "device":
        monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")
        monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "0")
    return request.param
