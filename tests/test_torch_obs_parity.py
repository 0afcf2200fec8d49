"""The port's producers against the JAX package's, end to end on the CPU.

The operator shapes of ``tests/test_torch_operator.py``,
``test_torch_disruption.py``, ``test_torch_admission.py`` and
``test_torch_interruption.py`` run through both packages' ``Environment``
(``TPUSolver`` against ``TorchSolver(device="cpu")``), each package with
its own tracer on and its planes reset, and the planes' records are held
equal:

- the decision records, in order, ``(site, rung, reason)`` with the JAX
  package's ``xla`` rung read as the port's ``device``;
- the timeline events in ring order, without their times and trace ids,
  generated names (nodes, claims, pods) numbered by first appearance;
- the anomaly kinds of every kept round;
- the padding and dispatch counts of ``devplane.STATS``;
- the compile ledger's ``(family, key, cold)`` sequence;
- each kept round's span-name tree.

One span exists only in the JAX package by design, listed in
``JAX_ONLY_SPANS`` with the reason; the comparison drops it, and the
``solve.kernel`` that consumes its result (which holds no dispatch of its
own there) is read with the port's ``solve.dispatch``/``solve.block``.

Tolerance: exact.
"""

from __future__ import annotations

import importlib
import re

import pytest

from tests import test_torch_admission as adm
from tests import test_torch_disruption as dis
from tests import test_torch_interruption as intr
from tests import test_torch_operator as op
from tests.test_torch_operator import JAX, PORT, Kit

JAX_ONLY_SPANS = {
    # TPUSolver._invoke_spec (karpenter_tpu/models/solver.py:888-921):
    # the doubled bin axis is dispatched asynchronously before the decode
    # so XLA overlaps it; the port's eager pack loop spends its time
    # launching kernels on the host and has nothing to overlap, so it
    # re-runs the doubled axis synchronously inside the next solve.kernel
    "solve.dispatch_spec":
        "speculative doubled dispatch; the port re-runs synchronously",
}

STATS_KEYS = ("cold_compiles", "warm_dispatches", "pad_dispatches",
              "pad_cells_actual", "pad_cells_padded", "bin_growths")


def planes(pkg):
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    return (mod("obs"), mod("obs.devplane"), mod("obs.decisions"),
            mod("obs.timeline"))


def _tree(span) -> tuple:
    return (span.name, tuple(_tree(c) for c in span.children))


def _drop_jax_only(tree):
    name, children = tree
    out, consumed = [], False
    for child in children:
        if child[0] in JAX_ONLY_SPANS:
            consumed = True
            continue
        child = _drop_jax_only(child)
        if consumed and child[0] == "solve.kernel" and not child[1]:
            child = ("solve.kernel", (("solve.dispatch", ()),
                                      ("solve.block", ())))
            consumed = False
        out.append(child)
    return name, tuple(out)


class _Names:
    """Generated names numbered by first appearance, one series per
    field."""

    def __init__(self):
        self.seen: dict = {}

    def __call__(self, field, value):
        table = self.seen.setdefault(field, {})
        return table.setdefault(value, f"{field}#{len(table)}")


def _event(ev, names) -> tuple:
    out = {}
    for key, value in ev.items():
        if key in ("at", "trace_id"):
            continue
        if key in ("node", "claim"):
            value = names("name", value)
        elif key == "pod":
            value = names("pod", value)
        elif key == "cause" and value:
            value = tuple(sorted(value.items()))
        out[key] = value
    return tuple(sorted(out.items()))


def capture(pkg, run, tmp_path):
    """Run ``run(pkg)`` with the package's planes reset and its tracer
    on; return the planes' records and whatever ``run`` returned."""
    obs, devplane, decisions, timeline = planes(pkg)
    obs.configure(enabled=True, dump_dir=str(tmp_path / pkg),
                  capacity=4096, dump_all=False)
    obs.RECORDER.clear()
    devplane.reset()
    decisions.reset()
    timeline.reset()
    seq, ledger = [], []
    record, dispatch = decisions.DECISIONS.record, devplane.LEDGER.record_dispatch

    def spy_record(site, rung, reason="ok", **kw):
        got = record(site, rung, reason, **kw)
        seq.append((site, "device" if rung == "xla" else rung, got))
        return got

    def spy_dispatch(family, key, seconds, **kw):
        cold = dispatch(family, key, seconds, **kw)
        ledger.append((family, key, cold))
        return cold

    decisions.DECISIONS.record = spy_record
    devplane.LEDGER.record_dispatch = spy_dispatch
    try:
        result = run(pkg)
    finally:
        del decisions.DECISIONS.record
        del devplane.LEDGER.record_dispatch
    traces = obs.RECORDER.traces()
    names = _Names()
    out = dict(
        decisions=seq,
        events=[_event(ev, names) for ev in
                timeline.timeline_snapshot(k=100000)["events"]],
        anomalies=[(t.name, tuple(k for k, _, _ in t.anomalies))
                   for t in traces],
        stats={k: devplane.STATS[k] for k in STATS_KEYS},
        ledger=ledger,
        trees=[_tree(t.root) for t in traces],
    )
    obs.reset()
    devplane.reset()
    timeline.reset()
    return out, result


def assert_same_planes(got, want):
    assert got["decisions"] == want["decisions"]
    assert got["events"] == want["events"]
    assert got["anomalies"] == want["anomalies"]
    assert got["stats"] == want["stats"]
    assert got["ledger"] == want["ledger"]
    assert got["trees"] == [_drop_jax_only(t) for t in want["trees"]]


def both(run, tmp_path):
    want, want_res = capture(JAX, run, tmp_path)
    got, got_res = capture(PORT, run, tmp_path)
    assert_same_planes(got, want)
    return got, got_res, want_res


def _names(tree) -> set:
    return {tree[0]} | set().union(*(_names(c) for c in tree[1]))


# ---------------------------------------------------------------------------
# the shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", sorted(op.PROVISIONING))
def test_provisioning_planes_match_jax(scenario, tmp_path):
    got, _, _ = both(lambda pkg: op._provisioned(pkg, scenario), tmp_path)
    rounds = {t[0] for t in got["trees"]}
    if scenario != "no-nodepool":
        assert "provision" in rounds
        assert any(d[0] == "solver.route" for d in got["decisions"])
    if scenario not in ("no-nodepool", "insufficient-capacity"):
        assert "launch" in {dict(e)["kind"] for e in got["events"]}


@pytest.mark.parametrize("shape", sorted(dis.SHAPES))
def test_disruption_shape_planes_match_jax(shape, tmp_path):
    def run(pkg):
        env, log = dis.SHAPES[shape][0](Kit(pkg))
        return tuple(log.commands)

    got, got_cmds, want_cmds = both(run, tmp_path)
    assert got_cmds == want_cmds
    if got_cmds:
        kinds = {dict(e)["kind"] for e in got["events"]}
        assert {"drain", "retire"} <= kinds


@pytest.mark.parametrize("fleet,knobs", [("config4-24", "global"),
                                         ("mixed-seed1", "ladder"),
                                         ("config4-24", "relax")])
def test_converging_fleet_planes_match_jax(fleet, knobs, tmp_path,
                                           monkeypatch):
    for name, value in dis.KNOBS[knobs].items():
        monkeypatch.setenv(name, value)

    def run(pkg):
        env, log, _, rounds = dis._converged(pkg, fleet)
        return tuple(log.commands), rounds

    got, got_res, want_res = both(run, tmp_path)
    assert got_res == want_res
    sites = {d[0] for d in got["decisions"]}
    assert {"snapshot.advance", "probe.confirm"} & sites
    assert any(d[0] == "fleet.reconcile" for d in got["decisions"])
    names = set().union(*(_names(t) for t in got["trees"]))
    assert {"snapshot.build", "probe.kernel", "disrupt.execute",
            "drain.evict"} <= names
    if knobs == "relax":
        assert {"global.relax", "relax.solve"} <= names
        assert any(f == "relax.kernel" for f, _, _ in got["ledger"])


def test_preempt_env_planes_match_jax(tmp_path):
    got, got_res, want_res = both(lambda pkg: adm._preempt_run(pkg, 4),
                                  tmp_path)
    assert got_res == want_res
    assert ("admission.preempt", "confirmed", "ok") in got["decisions"]
    names = set().union(*(_names(t) for t in got["trees"]))
    assert {"admission.preempt", "preempt.dispatch"} <= names


@pytest.mark.parametrize("shape", sorted(intr.SHAPES))
def test_interruption_shape_planes_match_jax(shape, tmp_path):
    def run(pkg):
        env, log, out = intr.SHAPES[shape](pkg)
        return tuple(log.commands), out

    got, got_res, want_res = both(run, tmp_path)
    assert got_res == want_res
    if shape != "unknown-node":
        assert any(d[0] == "disrupt.interruption" for d in got["decisions"])
        assert "interrupt" in {dict(e)["kind"] for e in got["events"]}


def test_storm_leg_planes_match_jax(tmp_path):
    def run(pkg):
        leg, cmds, end = intr.storm_leg.__wrapped__(pkg, 2.0)
        return leg, cmds, end

    got, got_res, want_res = both(run, tmp_path)
    assert got_res == want_res
    kinds = {dict(e)["kind"] for e in got["events"]}
    assert {"interrupt", "launch", "register", "bind", "drain",
            "retire"} <= kinds


def test_generated_names_are_numbered_not_compared():
    """The event canonicalisation keeps structure: the same node in two
    events keeps one number, two nodes get two."""
    names = _Names()
    a = _event({"kind": "launch", "node": "x-1", "claim": "x-1",
                "at": 1.0, "trace_id": "t"}, names)
    b = _event({"kind": "bind", "node": "x-2", "pod": "ns/p-9",
                "at": 2.0, "trace_id": "u"}, names)
    assert dict(a)["node"] == "name#0" == dict(a)["claim"]
    assert dict(b)["node"] == "name#1" and dict(b)["pod"] == "pod#0"
    assert re.fullmatch(r"name#\d+", dict(b)["node"])
