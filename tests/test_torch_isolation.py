"""The port stands alone: no JAX, nothing of the JAX package.

- A solve and a joint consolidation round (``joint_retirement_plan`` on
  a small underutilized fleet) through the port in a fresh interpreter
  load no ``jax`` module and no ``karpenter_tpu`` module.
- No file of ``karpenter_tpu_torch/`` imports either (AST scan, so lazy
  imports inside functions count too).
- ``TorchSolver()`` with no device raises when CUDA is absent instead of
  dropping to the CPU.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "karpenter_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "karpenter_tpu")

_SCRIPT = r"""
import json, sys
def loaded():
    return {m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "karpenter_tpu")}
before = loaded()
from karpenter_tpu_torch.models import TorchSolver
from karpenter_tpu_torch.workload import build_workload
pods, templates, its = build_workload(300, 60)
res = TorchSolver(device="cpu").solve(pods, templates, its)
from karpenter_tpu_torch.ops.consolidate import joint_retirement_plan
from karpenter_tpu_torch.workload import underutilized_fleet
store, cluster, prov, cands = underutilized_fleet(12, device="cpu")
plan = joint_retirement_plan(prov, cluster, store, cands, want_singles=True)
print(json.dumps({"new": sorted(loaded() - before),
                  "claims": res.node_count(),
                  "errors": len(res.pod_errors),
                  "retired": len(plan.selected_idx)}))
"""


def _forbidden(name: str | None) -> bool:
    return name is not None and name.split(".")[0] in FORBIDDEN


def test_port_solve_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["new"] == []
    assert got["claims"] > 0 and got["errors"] == 0
    assert got["retired"] >= 2


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert offenders == []


def test_default_device_raises_without_cuda(monkeypatch):
    from karpenter_tpu_torch.models import TorchSolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSolver()
    assert TorchSolver(device="cpu").device.type == "cpu"


def test_cuda_tensors_never_take_the_plain_version():
    """The compat wrapper refuses tensors it cannot launch on rather than
    computing them with the plain version."""
    from karpenter_tpu_torch.ops import cuda_kernels

    m = torch.zeros((2, 1, 1), dtype=torch.int32, device="meta")
    b = torch.zeros((2, 1), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_kernels.compat(m, b, b, m, b, b)
