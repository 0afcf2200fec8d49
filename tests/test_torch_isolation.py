"""The port stands alone: no JAX, nothing of the JAX package.

- A solve, a joint consolidation round (``joint_retirement_plan`` on
  a small underutilized fleet), and the operator loop — an
  ``Environment`` provisioning round and a disruption round that ships a
  command — through the port in a fresh interpreter load no ``jax``
  module and no ``karpenter_tpu`` module.
- No file of ``karpenter_tpu_torch/`` imports either (AST scan, so lazy
  imports inside functions count too).
- ``TorchSolver()`` with no device, and an ``Environment()`` with no
  solver, raise when CUDA is absent instead of dropping to the CPU.
- A solve routed to the native engine, and a probe routed to its batched
  entry, map the port's own library (built under ``build/``) and never
  the JAX package's ``libkarpenter_kernel.so``.
"""

import ast
import json
import os
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
from karpenter_tpu_torch.models import TorchSolver as TS
from karpenter_tpu_torch.workload import consolidation_env
env = consolidation_env(9, solver=TS(device="cpu"))
provisioned = len(env.store.list("nodes"))
env.clock.step(20.0)
env.run_until_idle()
print(json.dumps({"new": sorted(loaded() - before),
                  "claims": res.node_count(),
                  "errors": len(res.pod_errors),
                  "retired": len(plan.selected_idx),
                  "provisioned": provisioned,
                  "consolidated": len(env.store.list("nodes")),
                  "bound": sum(1 for p in env.store.list("pods")
                               if p.node_name)}))
"""


_NATIVE_SCRIPT = r"""
import json, os
from karpenter_tpu_torch import native
from karpenter_tpu_torch.models import TorchSolver
from karpenter_tpu_torch.ops.consolidate import joint_retirement_plan
from karpenter_tpu_torch.workload import build_workload, underutilized_fleet
pods, templates, its = build_workload(300, 60)
solver = TorchSolver(device="cpu")
res = solver.solve(pods, templates, its)
store, cluster, prov, cands = underutilized_fleet(12, device="cpu")
plan = joint_retirement_plan(prov, cluster, store, cands, want_singles=True)
with open("/proc/self/maps") as f:
    maps = sorted({line.split()[-1] for line in f if ".so" in line})
print(json.dumps({"engine": solver.last_device_stats["engine"],
                  "retired": len(plan.selected_idx),
                  "lib": str(native.lib_path()), "maps": maps}))
"""


def test_routed_solve_maps_only_the_ports_library():
    env = dict(os.environ, KARPENTER_NATIVE_CUTOFF="192")
    out = subprocess.run(
        [sys.executable, "-c", _NATIVE_SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["engine"] == "native" and got["retired"] >= 2
    assert got["lib"] in got["maps"]
    assert Path(got["lib"]).is_relative_to(ROOT / "build")
    jax_pkg = str(ROOT / "karpenter_tpu") + os.sep
    assert not [m for m in got["maps"]
                if m.startswith(jax_pkg) or "libkarpenter_kernel" in m]


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
    assert got["provisioned"] == 9
    assert got["consolidated"] == 3 and got["bound"] == 9


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


def test_default_environment_raises_without_cuda(monkeypatch):
    """``Environment()`` with no solver means ``TorchSolver()`` (CUDA): it
    raises without a card, and runs on the CPU only when asked."""
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.operator import Environment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Environment()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Environment(enable_disruption=True)
    env = Environment(solver=TorchSolver(device="cpu"))
    assert env.provisioner.solver.device.type == "cpu"


def test_cuda_tensors_never_take_the_plain_version():
    """The compat wrapper refuses tensors it cannot launch on rather than
    computing them with the plain version."""
    from karpenter_tpu_torch.ops import cuda_kernels

    m = torch.zeros((2, 1, 1), dtype=torch.int32, device="meta")
    b = torch.zeros((2, 1), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_kernels.compat(m, b, b, m, b, b)
