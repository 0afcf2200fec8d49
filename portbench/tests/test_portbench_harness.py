"""The harness end to end on the CPU at a small size: the result line, a
cell added by files alone, and faults planted under the timed path that
``correct`` has to catch."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import run, system
from portbench.reference import judge as ref
from portbench.spec import Spec
from portbench.tests.conftest import ROOT

SEED = 2**31 + 4099


def _run(root, name, trace=False, seconds=0.05):
    spec = Spec(root)
    return run.run_cell(spec, spec.cell(name), SEED, seconds, trace, device="cpu")


@pytest.mark.parametrize("name", ["burst-50k", "diverse-500", "generic-500"])
def test_result_line(small_root, name):
    spec = Spec(small_root)
    out = _run(small_root, name)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    pods = spec.traffic(spec.cell(name))["pods"]
    assert out["attempted"] == pods * out["run"]["decisions"]
    want = {m["name"]: m["unit"] for m in spec.metrics(spec.cell(name), "end_to_end")}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["checks"] == {"breaches": {"value": 0, "limit": 0}}
    assert set(out["run"]["breaches"]) == set(ref.CHECKS)
    json.dumps(out)


def test_traced_result_line(small_root, monkeypatch):
    monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")  # the device path
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "0")
    out = _run(small_root, "diverse-500", trace=True)
    assert out["correct"] is True
    # span readers read on the CPU; the device trace has nothing to read
    assert {"route_device_pct", "unspanned_ms", "waves_ms", "tensorize_ms",
            "dispatch_ms", "decode_ms"} <= set(out["metrics"])
    assert not {"kernels_per_decide", "compat_roofline_pct",
                "device_idle_pct"} & set(out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0
    assert list(out)[-1] == "checks"


def test_detail_records_every_decision(small_root):
    """``--detail``: one record per decision with its milliseconds, the
    collector's and the program's spans, for reading drift by decision."""
    spec = Spec(small_root)
    detail: list = []
    out = run.run_cell(spec, spec.cell("diverse-500"), SEED, 0.05, False,
                       device="cpu", detail=detail)
    assert len(detail) == out["run"]["decisions"]
    assert [round(r["ms"], 1) for r in detail] == out["run"]["ms"]
    assert all(r["gc_ms"] >= 0 and "tensorize.build" in r["spans"] for r in detail)


def test_a_cell_added_by_files_alone(small_root):
    """A new mix, a new cell and a new per-layer metric: new files under
    the benchmark's folders and new entries in BENCHMARK.json, and no
    other file changed."""
    base = small_root.parent / "portbench"
    traffic = json.loads((base / "traffic" / "generic-500.json").read_text())
    traffic.update(pods=64, ring=3, sample=3)
    (base / "traffic" / "tiny-mix.json").write_text(json.dumps(traffic))
    (base / "metrics" / "decisions_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.all_decisions))\n")
    doc = json.loads(small_root.read_text())
    doc["workloads"].append({"name": "tiny", "config": "upstream-400types",
                             "traffic": "tiny-mix", "chips": 1, "why": "a test"})
    doc["per_layer"].append({"name": "decisions_seen", "unit": "decisions",
                             "better": "higher", "source": "program_counter",
                             "layer": "solver entry", "moves": "pods_per_s",
                             "workloads": ["tiny"]})
    small_root.write_text(json.dumps(doc))
    out = _run(small_root, "tiny", trace=True)
    assert out["correct"] is True
    assert out["metrics"]["decisions_seen"]["value"] == out["run"]["decisions"]
    assert out["run"]["decisions"] >= 3


def _faulty(monkeypatch, fault):
    decide = system.Program.decide
    last: dict = {}

    def broken(self, batch):
        from karpenter_tpu_torch.models.scheduler import SchedulerResults

        if fault == "half":
            pods, batch.pods = batch.pods, batch.pods[::2]
            try:
                return decide(self, batch)
            finally:
                batch.pods = pods
        results, trace = decide(self, batch)
        if fault == "unchanged":
            # the state handed in comes back: nothing decided
            return SchedulerResults([], [], {}), trace
        if fault == "stale":
            # the previous decision's answer comes back again
            stale = last.get("results", results)
            last["results"] = results
            return stale, trace
        if fault == "altered":
            # where the answer is produced: one instance type dropped from
            # a claim (moving a pod between claims can leave a sound answer)
            claim = results.new_claims[0]
            claim.instance_types = claim.instance_types[:-1]
        return results, trace

    monkeypatch.setattr(system.Program, "decide", broken)


@pytest.mark.parametrize("fault", ["unchanged", "stale", "half", "altered"])
@pytest.mark.parametrize("name", ["burst-50k", "diverse-500", "generic-500"])
def test_a_broken_timed_path_is_not_correct(small_root, monkeypatch, name, fault):
    _faulty(monkeypatch, fault)
    out = _run(small_root, name)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["breaches"]["value"] > 0


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints nothing."""
    proc = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                           "burst-50k", "--seed", "1", "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_alone_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, the command exits non-zero and prints nothing."""
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                           "burst-50k", "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
