"""On the card: one short run of each cell through the command, at its
full size. ``python -m pytest portbench/tests -m card`` on a machine with
a CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("name", ["burst-50k", "diverse-500", "generic-500"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, name, trace):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", name, "--seed",
         str(2**31 + 17), "--seconds", "1", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert out["device"]["busy_s"] > 0
        assert 0 < out["metrics"]["compat_roofline_pct"]["value"] <= 100
