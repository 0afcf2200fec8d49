"""The engine ladder's seam: one module decides which engine runs.

- Each routing knob (``KARPENTER_NATIVE_CUTOFF``, ``KARPENTER_HOST_CUTOFF``,
  ``KARPENTER_DEVICE_MIN_WORK``, ``KARPENTER_ASSUME_ACCELERATOR`` and
  ``KARPENTER_RELAX``) is named as a string in exactly one place of the
  port's code, ``ops/engines.py`` (``utils/envknobs.py`` only documents
  them): an AST scan of every file, so a read through any accessor, or a
  second copy of a gate, counts.
- The lower layers that ask the policy (``ops/relax.py``,
  ``ops/consolidate.py``, ``obs/capsule.py``) and ``ops/engines.py``
  itself import nothing from ``models/solver.py``, lazy imports inside
  functions included.
- The gates decide as the solver's dispatches route: the host cutoff
  follows the master switch, and the replay rung and the capture's
  engine name read one mapping.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.ops import engines

PKG = Path(__file__).resolve().parent.parent / "karpenter_tpu_torch"
KNOBS = ("KARPENTER_NATIVE_CUTOFF", "KARPENTER_HOST_CUTOFF",
         "KARPENTER_DEVICE_MIN_WORK", "KARPENTER_ASSUME_ACCELERATOR",
         "KARPENTER_RELAX")
ASKERS = ("ops/relax.py", "ops/consolidate.py", "obs/capsule.py",
          "ops/engines.py")


def _trees():
    for path in sorted(PKG.rglob("*.py")):
        yield path.relative_to(PKG).as_posix(), ast.parse(path.read_text())


def _knob_sites(name):
    return [(rel, node.lineno) for rel, tree in _trees()
            for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and node.value == name]


@pytest.mark.parametrize("name", KNOBS)
def test_routing_knob_read_once_in_engines(name):
    sites = _knob_sites(name)
    assert [rel for rel, _ in sites] == ["ops/engines.py"], sites


def _solver_imports(tree):
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "karpenter_tpu_torch.models.solver" or (
                    mod == "karpenter_tpu_torch.models"
                    and any(a.name == "solver" for a in node.names)):
                found.append(node.lineno)
        elif isinstance(node, ast.Import):
            found += [node.lineno for a in node.names
                      if a.name == "karpenter_tpu_torch.models.solver"]
    return found


@pytest.mark.parametrize("rel", ASKERS)
def test_lower_layer_imports_nothing_from_the_solver(rel):
    tree = ast.parse((PKG / rel).read_text())
    assert _solver_imports(tree) == [], f"{rel} imports models.solver"


@pytest.mark.parametrize("cutoff,host", [(None, engines.HOST_CUTOFF_PODS),
                                         ("0", 0), ("192", 8)])
def test_host_cutoff_follows_the_master_switch(cutoff, host, monkeypatch):
    if cutoff is None:
        monkeypatch.delenv("KARPENTER_NATIVE_CUTOFF", raising=False)
    else:
        monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", cutoff)
    monkeypatch.delenv("KARPENTER_HOST_CUTOFF", raising=False)
    assert engines.host_cutoff() == host


@pytest.mark.parametrize("engine,captured,rung", [
    ("cuda", "device", "device"), ("cpu", "device", "device"),
    ("native", "native", "native"), ("remote", "remote", "device"),
    ("mesh", "device", "device"),
])
def test_capture_and_replay_names(engine, captured, rung):
    assert engines.capture_engine(engine) == captured
    assert engines.replay_rung(captured) == rung


@pytest.mark.parametrize("engine,rung", [
    ("partitioned", "partitioned"), ("replicated", "replicated"),
    ("unsharded", "device"), (None, "device"),
])
def test_mesh_captures_replay_on_their_rung(engine, rung):
    assert engines.replay_rung(engine) == rung


def test_probe_and_solve_gates_share_the_work_floor(monkeypatch):
    """One work floor steers both gates: a snapshot just under it routes
    a probe and a solve to the native engine, at it neither."""
    from karpenter_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: True)
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "192")
    monkeypatch.setenv("KARPENTER_DEVICE_MIN_WORK", "16")
    monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")
    args = {"g_count": np.array([100, 100, 100, 0]),
            "t_alloc": np.ones((4, 4), dtype=np.float32)}
    assert engines.native_reason(args, torch.device("cpu")) == "work-floor"
    assert engines.probe_native(3, 4)
    args["g_count"][3] = 100
    assert engines.native_reason(args, torch.device("cpu")) is None
    assert not engines.probe_native(4, 4)
