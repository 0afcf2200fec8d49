"""The port's own layer spans, the LP floor's iteration count and the
tracer's ranges in ``torch.profiler``'s trace, on the CPU.

Each decision runs through ``TorchSolver(device="cpu")`` on the device
path (``KARPENTER_ASSUME_ACCELERATOR=1``, ``KARPENTER_NATIVE_CUTOFF=0``),
where the LP floor's gate is on as on the card. The JAX package opens
none of these spans; ``tests/test_torch_obs_parity.py`` strips them
before it compares the two packages' trees.
"""

from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from karpenter_tpu_torch import obs, workload
from karpenter_tpu_torch.controllers.provisioning.provisioner import collect_domains
from karpenter_tpu_torch.models.solver import TorchSolver
from karpenter_tpu_torch.models.topology import Topology
from karpenter_tpu_torch.ops import relax


@pytest.fixture
def device_path(monkeypatch, tmp_path):
    monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "0")
    monkeypatch.delenv("KARPENTER_RELAX", raising=False)
    monkeypatch.delenv("KARPENTER_PROFILE_DIR", raising=False)
    obs.reset()
    obs.configure(enabled=True, dump_dir=str(tmp_path / "dumps"), capacity=8)
    yield
    obs.reset()


def decide(topology: bool):
    """One traced provisioning decision: 240 pods of the headline's shapes
    or, with ``topology``, 120 of the diverse mix with the round's
    ``Topology`` built inside it. Returns the trace and the solver."""
    pods, templates, its = workload.build_workload(240, 40)
    if topology:
        pods = workload.diverse_pods(120)
    solver = TorchSolver(device="cpu")
    with obs.round_trace("provision") as trace:
        topo = None
        if topology:
            domains: dict = {}
            for t in templates:
                collect_domains(domains, t, its[t.nodepool_name])
            topo = Topology(domains=domains, pods=pods)
        solver.solve(pods, templates, its, topology=topo)
    return trace, solver


def _child(span, name):
    return next(c for c in span.children if c.name == name)


@pytest.mark.parametrize("topology", [False, True], ids=["plain", "topology"])
def test_layer_spans_open_under_the_round(device_path, topology):
    trace, solver = decide(topology)
    assert solver.last_device_stats["engine"] == "cpu"
    names = [c.name for c in trace.root.children]
    # no span encloses the solve: its stages are the round's children
    order = ["solve.classify", "tensorize.build", "solve.plan", "solve.kernel",
             "solve.decode", "solve.commit"]
    if topology:
        order = ["topology.build", "solve.classify", "waves.compile"] + order[1:]
    assert [n for n in names if n in order] == order
    plan = _child(trace.root, "solve.plan")
    assert [c.name for c in plan.children] == ["relax.inputs", "relax.floor"]
    assert _child(plan, "relax.floor").kind == "device"
    dispatch = _child(_child(trace.root, "solve.kernel"), "solve.dispatch")
    assert set(dispatch.attrs) == {"Gp", "Bp", "level_bits"}
    assert dispatch.attrs["Bp"] == solver.last_device_stats["bins"]


def test_floor_iters_counts_what_floor_lb_returns(device_path, monkeypatch):
    returned = []
    floor_lb = relax.floor_lb

    def spy(*args, **kw):
        out = floor_lb(*args, **kw)
        returned.append(out[1])
        return out

    monkeypatch.setattr(relax, "floor_lb", spy)
    before = dict(relax.RELAX_STATS)
    trace, solver = decide(False)
    after = relax.RELAX_STATS
    assert len(returned) == 1 and returned[0] > 0
    assert after["floor_calls"] - before["floor_calls"] == 1
    assert after["floor_iters"] - before["floor_iters"] == returned[0]
    assert "kernel_ms" not in after
    floor = _child(_child(trace.root, "solve.plan"), "relax.floor")
    assert floor.attrs["iters"] == returned[0]
    assert floor.attrs["raised"] == (after["floor_raises"] > before["floor_raises"])
    stats = solver.last_device_stats
    assert (floor.attrs["Gp"], floor.attrs["Tp"]) == (
        relax._pow2(stats["groups"], lo=2), relax._pow2(stats["types"], lo=2))


def _span_tree(trace) -> tuple:
    def walk(sp):
        return (sp.name, tuple(walk(c) for c in sp.children))

    return (f"round {trace.trace_id}", walk(trace.root)[1])


def _range_tree(events, names) -> list:
    """The profiler's ranges named in ``names``, nested by the profiler's
    own parent links (each under its nearest ancestor among them)."""
    ranges = [e for e in events if e.name in names]
    ids = {id(e) for e in ranges}
    kids: dict = {id(e): [] for e in ranges}
    roots = []
    for e in sorted(ranges, key=lambda e: e.time_range.start):
        parent = e.cpu_parent
        while parent is not None and id(parent) not in ids:
            parent = parent.cpu_parent
        (kids[id(parent)] if parent is not None else roots).append(e)

    def walk(e):
        return (e.name, tuple(walk(c) for c in kids[id(e)]))

    return [walk(r) for r in roots]


def test_spans_are_ranges_in_the_profilers_trace(device_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace, _ = decide(True)
    want = _span_tree(trace)
    names = {sp.name for sp in trace.spans() if sp is not trace.root}
    names.add(want[0])
    assert _range_tree(prof.events(), names) == [want]
    assert {"topology.build", "solve.plan", "relax.floor"} <= names
    # function-scope records, not user annotations: a user annotation
    # would also lay an event over the device's timeline
    marks = [e for e in prof.profiler.kineto_results.events()
             if e.name() in names]
    assert len(marks) == len(names) and not any(
        e.is_user_annotation() for e in marks)


def test_no_profiler_makes_no_range(device_path, monkeypatch):
    def no_range(*args, **kw):
        raise AssertionError("a profiler range opened with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    trace, _ = decide(True)
    assert len(trace.spans()) > 10
    # the tracer does reach the patched function while a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler"):
            with obs.round_trace("provision"):
                pass


def test_profile_dir_trace_holds_the_dispatch_spans(device_path, monkeypatch,
                                                    tmp_path):
    monkeypatch.setenv("KARPENTER_PROFILE_DIR", str(tmp_path / "prof"))
    decide(False)
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"solve.dispatch", "solve.block"} <= names
