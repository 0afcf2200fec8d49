"""The readers of the solver's layer spans and the LP floor's counter on
the CPU: a traced small-size run on the port's device path reports each
of them in the cells that list it, and the time left outside every
program span falls below what the plan and the classify spans took."""

from __future__ import annotations

import pytest

from portbench import run
from portbench.spec import Spec

SEED = 2**31 + 4111
NEW = ("plan_ms", "lp_floor_ms", "lp_floor_iters", "classify_ms", "topology_ms")


@pytest.mark.parametrize("name", ["burst-50k", "diverse-500", "generic-500"])
def test_layer_metrics_read_in_their_cells(small_root, monkeypatch, name):
    monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")  # the device path
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "0")
    spec = Spec(small_root)
    cell = spec.cell(name)
    out = run.run_cell(spec, cell, SEED, 0.05, True, device="cpu")
    assert out["correct"] is True
    want = {m["name"] for m in spec.metrics(cell, "per_layer")} & set(NEW)
    got = out["metrics"]
    assert {"plan_ms", "lp_floor_ms", "lp_floor_iters"} <= want
    assert want <= set(got) and all(got[m]["value"] > 0 for m in want)
    assert ("classify_ms" in want) == (name == "burst-50k")
    assert ("topology_ms" in want) == (name == "diverse-500")
    assert got["lp_floor_ms"]["value"] <= got["plan_ms"]["value"]
    assert got["unspanned_ms"]["value"] < (
        got["plan_ms"]["value"] + got.get("classify_ms", {"value": 0.0})["value"])
