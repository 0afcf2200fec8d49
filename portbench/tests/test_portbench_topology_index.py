"""The reader of ``topology_index_hit_pct`` on the CPU: nothing where no
``topology.count`` span carries ``walked``; the share from hand-made
spans; and, in the live cell at the small size of
``test_portbench_live.py``, one walk a decision and the share in the
cell's traced result line."""

from __future__ import annotations

from types import SimpleNamespace

from portbench import live, live_system, run
from portbench.metrics import topology_index_hit_pct
from portbench.tests.test_portbench_live import (  # noqa: F401  (fixture)
    SEED,
    _run,
    _setup,
    live_root,
)


def _ctx(*decisions):
    return SimpleNamespace(decisions=list(decisions))


def _count(**attrs):
    return ["topology.count", attrs]


def test_nothing_where_no_span_carries_walked():
    assert topology_index_hit_pct.read(_ctx()) is None
    assert topology_index_hit_pct.read(_ctx({"span_attrs": []})) is None
    # a program that walks the cluster once per group: ``pods`` alone
    assert topology_index_hit_pct.read(_ctx(
        {"span_attrs": [_count(pods=30), _count(pods=12)]},
        {"spans": {"topology.count": 5.0}})) is None


def test_the_share_from_hand_made_spans():
    first = {"span_attrs": [_count(pods=4),  # the inverse anti-affinity walk
                            _count(pods=10, walked=30, tests=7),
                            _count(pods=12, walked=0, tests=7),
                            _count(pods=30, walked=0, tests=0),
                            ["existing.capacity", {"walked": 5}]]}
    second = {"span_attrs": [_count(pods=9, walked=30, tests=7),
                             _count(pods=9, walked=0, tests=7)]}
    assert topology_index_hit_pct.read(_ctx(first)) == 100.0 * 2 / 3
    assert topology_index_hit_pct.read(_ctx(first, second, {})) == 100.0 * 3 / 5


def test_one_walk_in_a_decision(live_root):
    _, _, cfg, traffic, plain_catalog, _ = _setup(live_root)
    program = live_system.Program(cfg, plain_catalog, traffic, "cpu")
    plain = live.ring(cfg, plain_catalog, traffic, SEED)[0]
    _, trace = program.decide(program.batch(plain))
    spans = run._span_attrs(trace)
    counts = [a for n, a in spans if n == "topology.count" and "walked" in a]
    assert len(counts) > 1
    assert sum(a["walked"] > 0 for a in counts) == 1
    share = topology_index_hit_pct.read(_ctx({"span_attrs": spans}))
    assert share == 100.0 * (len(counts) - 1) / len(counts)


def test_the_share_in_the_cells_traced_result_line(live_root, monkeypatch):
    monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")  # the device path
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "0")
    spec, cell, *_ = _setup(live_root)
    out = _run(live_root, trace=True)
    assert out["correct"] is True, out["checks"]
    listed = {m["name"] for m in spec.metrics(cell, "per_layer")}
    assert "topology_index_hit_pct" in listed <= set(out["metrics"])
    assert 0 < out["metrics"]["topology_index_hit_pct"]["value"] < 100
