"""The reader of ``truncate_memo_hit_pct`` on the CPU, in the live cell at
the small size of ``test_portbench_live.py``: nothing before any
truncation, nor from spans without the counts; after a decision, the share
of its offering table's lookups that the memo answered."""

from __future__ import annotations

from types import SimpleNamespace

from portbench import live, live_system, run
from portbench.metrics import truncate_memo_hit_pct
from portbench.tests.test_portbench_live import (  # noqa: F401  (fixture)
    SEED,
    _run,
    _setup,
    live_root,
)


def _ctx(*decisions):
    return SimpleNamespace(decisions=list(decisions))


def test_nothing_before_any_truncation():
    assert truncate_memo_hit_pct.read(_ctx()) is None
    assert truncate_memo_hit_pct.read(_ctx({"span_attrs": []})) is None
    # a program without the offering table: the span carries only ``claims``
    assert truncate_memo_hit_pct.read(
        _ctx({"span_attrs": [["provision.truncate", {"claims": 4}]]})) is None


def test_the_share_after_one_decision(live_root):
    _, _, cfg, traffic, plain_catalog, _ = _setup(live_root)
    program = live_system.Program(cfg, plain_catalog, traffic, "cpu")
    plain = live.ring(cfg, plain_catalog, traffic, SEED)[0]
    _, trace = program.decide(program.batch(plain))
    spans = run._span_attrs(trace)
    counts = [a for n, a in spans if n == "provision.truncate"]
    assert len(counts) == 1 and counts[0]["claims"] > 1
    hits, evals = counts[0]["memo_hits"], counts[0]["compat_evals"]
    share = truncate_memo_hit_pct.read(_ctx({"span_attrs": spans}))
    assert 0 < share < 100 and share == 100.0 * hits / (hits + evals)


def test_the_share_in_the_cells_traced_result_line(live_root, monkeypatch):
    monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")  # the device path
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "0")
    spec, cell, *_ = _setup(live_root)
    out = _run(live_root, trace=True)
    assert out["correct"] is True, out["checks"]
    listed = {m["name"] for m in spec.metrics(cell, "per_layer")}
    assert "truncate_memo_hit_pct" in listed <= set(out["metrics"])
    assert 0 < out["metrics"]["truncate_memo_hit_pct"]["value"] <= 100
