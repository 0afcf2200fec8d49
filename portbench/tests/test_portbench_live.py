"""The live kind on the CPU at a small size (24 running nodes, a burst of
120 pods): the port against the plain reference, faults planted where the
answer is produced, the control, the generator and the reset."""

from __future__ import annotations

import copy
import json
import pickle

import pytest

from portbench import fleet, gen, live, live_system, run
from portbench.reference import live as ref
from portbench.reference import live_control as control
from portbench.spec import Spec
from portbench.tests.conftest import ROOT

CELL = "live-5000"
SEED = 2**31 + 4153
BURST = 120


@pytest.fixture
def live_root(small_root):
    """The small benchmark with the live cell's burst cut to ``BURST``."""
    spec = Spec(small_root)
    path = spec.base / "traffic" / f"{spec.cell(CELL)['traffic']}.json"
    traffic = json.loads(path.read_text())
    traffic["pods"] = BURST
    path.write_text(json.dumps(traffic))
    return small_root


def _setup(root):
    spec = Spec(root)
    cell = spec.cell(CELL)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    plain_catalog = gen.catalog(cfg)
    return spec, cell, cfg, traffic, plain_catalog, ref.Catalog(cfg, plain_catalog)


def _run(root, trace=False, seed=SEED):
    spec, cell, *_ = _setup(root)
    return run.run_cell(spec, cell, seed, 0.05, trace, device="cpu")


@pytest.mark.parametrize("seed", [3, 11, 2**31 + 7, 2**33 + 5])
def test_port_is_correct_by_the_reference(live_root, seed, engine):
    _, _, cfg, traffic, plain_catalog, cat = _setup(live_root)
    program = live_system.Program(cfg, plain_catalog, traffic, "cpu")
    for plain in live.ring(cfg, plain_catalog, traffic, seed):
        results, _ = program.decide(program.batch(plain))
        answer = program.answer(results)
        assert ref.judge(cfg, cat, plain, answer) == dict.fromkeys(ref.CHECKS, 0)
        # the running nodes' free capacity takes part of the burst
        assert answer["existing"] and answer["claims"]
        assert ref.placed(plain, answer) == BURST


def test_result_line(live_root):
    spec, cell, *_ = _setup(live_root)
    out = _run(live_root)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["checks"] == {"breaches": {"value": 0, "limit": 0}}
    assert set(out["run"]["breaches"]) == set(ref.CHECKS)
    assert out["attempted"] == BURST * out["run"]["decisions"]
    want = {m["name"] for m in spec.metrics(cell, "end_to_end")}
    assert set(out["metrics"]) == want == {"decide_p50_ms", "usd_per_kpod_h", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


def test_layer_metrics_read_in_the_cell(live_root, monkeypatch):
    monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")  # the device path
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "0")
    spec, cell, *_ = _setup(live_root)
    out = _run(live_root, trace=True)
    assert out["correct"] is True, out["checks"]
    listed = {m["name"] for m in spec.metrics(cell, "per_layer")}
    assert listed == {"topology_count_ms", "existing_capacity_ms",
                      "existing_topology_ms", "existing_placed"}
    assert listed <= set(out["metrics"])
    assert all(out["metrics"][m]["value"] > 0 for m in listed)
    assert out["run"]["engines"] == ["cpu"]


def _first_pod(answer, pick=lambda n: True):
    """(where, name) of the first placed pod whose name passes ``pick``:
    ``where`` is a claim's index or an existing node's name."""
    for i, c in enumerate(answer["claims"]):
        for n in c["pods"]:
            if pick(n):
                return i, n
    for node, names in answer["existing"].items():
        for n in names:
            if pick(n):
                return node, n
    raise AssertionError("no such pod placed")


def _remove(answer, where, name):
    if isinstance(where, int):
        answer["claims"][where]["pods"].remove(name)
    else:
        answer["existing"][where].remove(name)


def _broken(monkeypatch, fault):
    """Plant ``fault`` where the live kind's answer is produced."""
    answer_of = live_system.answer

    def twice(a):
        where, name = _first_pod(a)
        node = next(n for n in a["existing"] if n != where)
        a["existing"][node].append(name)

    def dropped(a):
        _remove(a, *_first_pod(a))

    def anti_on_one_node(a):
        node = next(iter(a["existing"]))
        for _ in range(2):
            where, name = _first_pod(
                a, lambda n: n.startswith("xh-") and n not in a["existing"][node])
            _remove(a, where, name)
            a["existing"][node].append(name)

    edits = {"placed_twice": twice, "dropped": dropped,
             "anti_on_one_node": anti_on_one_node}
    if fault in edits:
        def broken(results):
            out = answer_of(results)
            edits[fault](out)
            return out

        monkeypatch.setattr(live_system, "answer", broken)
    elif fault == "overfilled":
        # the program sees each node without its largest running pod
        from karpenter_tpu_torch import obs

        def decide(self, lv):
            nodes = lv.cluster.nodes()
            for sn in nodes:
                del sn.pods[max(sn.pods, key=lambda k: sn.pods[k].effective_requests()["cpu"])]
            with obs.round_trace("provision") as trace:
                results = lv.provisioner.schedule(state_nodes=nodes)
            return results, (trace if isinstance(trace, obs.Trace) else None)

        monkeypatch.setattr(live_system.Program, "decide", decide)
    elif fault == "spread_without_running":
        from karpenter_tpu_torch.models import topology

        monkeypatch.setattr(topology.Topology, "_count_domains", lambda self, tg: None)
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("fault,check", [
    ("placed_twice", "accounting"), ("dropped", "accounting"),
    ("overfilled", "existing_capacity"), ("spread_without_running", "spread"),
    ("anti_on_one_node", "anti")])
def test_a_broken_timed_path_is_not_correct(live_root, monkeypatch, fault, check):
    _broken(monkeypatch, fault)
    out = _run(live_root)
    assert out["correct"] is False, out["checks"]
    assert out["run"]["breaches"][check] > 0, out["run"]["breaches"]


@pytest.mark.parametrize("seed", [1, 2, 2**33 + 7])
def test_control_is_not_correct(live_root, seed):
    """The bfloat16 control in the program's place, through the harness's
    own ``run_cell``: ``correct`` false, and its precision overfills the
    running nodes (``existing_capacity``)."""
    spec, cell, *_ = _setup(live_root)
    out = control.run(spec, cell, seed, 0.05, "cpu")
    assert out["correct"] is False, out["checks"]
    assert out["run"]["breaches"]["existing_capacity"] > 0, out["run"]["breaches"]
    assert out["run"]["engines"] == ["control"]


def test_control_in_float64_fits_the_running_nodes(live_root, monkeypatch):
    """In float64 the same packer overfills no running node: the
    control's ``existing_capacity`` reading is its precision alone."""
    import torch

    from portbench.reference import consolidation_control

    monkeypatch.setattr(consolidation_control, "LOW", torch.float64)
    monkeypatch.setattr(control.control, "LOW", torch.float64)
    spec, cell, *_ = _setup(live_root)
    out = control.run(spec, cell, 5, 0.05, "cpu")
    assert out["run"]["breaches"]["existing_capacity"] == 0, out["run"]["breaches"]
    assert out["run"]["breaches"]["accounting"] == 0


def test_ring_is_deterministic_per_seed(live_root):
    _, _, cfg, traffic, plain_catalog, _ = _setup(live_root)
    seed = 2**31 + 991
    one = live.ring(cfg, plain_catalog, traffic, seed)
    assert one == live.ring(cfg, plain_catalog, traffic, seed)
    # every seed does the same work: the same inputs, in another order
    other = live.ring(cfg, plain_catalog, dict(traffic, ring=4), seed + 1)
    assert sorted(x["index"] for x in other) == [1, 2, 3, 4]
    assert {x["index"]: x for x in other}[one[0]["index"]] == one[0]
    assert len(one[0]["burst"]) == BURST
    assert len(one[0]["pods"]) == 30 * traffic["nodes"]


def test_running_pods_are_fleet_pods_with_one_label_a_deployment(live_root):
    """The running cluster is ``fleet.fleet``'s output, its pods given
    one ``my-label`` value a deployment, and the burst is ``gen._mix``'s."""
    _, _, cfg, traffic, _, cat = _setup(live_root)
    plain = live.live(cfg, cat, traffic, 2)
    base = fleet.fleet(cfg, cat, traffic, 2)
    assert plain["nodes"] == base["nodes"]
    key = traffic["label_key"]
    by_deployment: dict = {}
    for p, q in zip(plain["pods"], base["pods"]):
        assert {k: v for k, v in p.items() if k != "labels"} == {
            k: v for k, v in q.items() if k != "labels"}
        assert set(p["labels"]) == {key} and p["labels"][key] in traffic["values"]
        by_deployment.setdefault(p["deployment"], set()).add(p["labels"][key])
    assert all(len(v) == 1 for v in by_deployment.values())
    assert len({v for vs in by_deployment.values() for v in vs}) > 3
    assert plain["burst"] == gen._mix(traffic, 2)


def test_fleet_output_for_fleet_2000_is_unchanged(small_root):
    """Drawing live inputs leaves ``fleet.fleet``'s output for
    ``consolidate-2000``'s traffic as it was, and writes no shared dict."""
    spec = Spec(small_root)
    cell = spec.cell("consolidate-2000")
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    cat = ref.Catalog(cfg, gen.catalog(cfg))
    before = copy.deepcopy(fleet.fleet(cfg, cat, traffic, 1))
    _, _, lcfg, ltraffic, lcat_plain, lcat = _setup(small_root)
    live.live(lcfg, lcat, dict(ltraffic, pods=BURST), 1)
    assert fleet.fleet(cfg, cat, traffic, 1) == before
    assert gen._NONE == {}
    assert all(p["labels"] == {} for p in before["pods"])


def _state(objects) -> list:
    out = []
    for o in objects:
        for k, v in o.__dict__.items():
            try:
                out.append((k, pickle.dumps(v)))
            except (TypeError, pickle.PicklingError):
                out.append((k, type(v).__name__))
    return out


def test_a_decision_leaves_its_cluster_as_it_was_after_reset(live_root):
    """A decision memoises on the pods; ``Live.reset`` hands the next
    decision every pod, node, NodeClaim and StateNode as made, and it
    decides the same."""
    _, _, cfg, traffic, plain_catalog, _ = _setup(live_root)
    program = live_system.Program(cfg, plain_catalog, traffic, "cpu")
    lv = program.batch(live.ring(cfg, plain_catalog, traffic, 9)[0])
    made = _state(lv._objects)
    first = program.answer(program.decide(lv)[0])
    assert _state(lv._objects) != made  # the decision memoised on the pods
    lv.reset()
    assert _state(lv._objects) == made
    assert program.answer(program.decide(lv)[0]) == first
    # no claim was created and no pod bound
    assert len(lv.store.list("nodeclaims")) == len(lv.plain["nodes"])
    assert all(not p.node_name for p in lv.pods)


def test_the_kind_is_files_alone(live_root):
    """The harness's own files name no part of the live kind: the cell
    runs through ``run_cell`` from its files and entries."""
    for name in ("run.py", "spec.py", "gen.py", "system.py", "fleet.py", "disrupt.py"):
        text = (ROOT / "portbench" / name).read_text()
        assert not any(w in text for w in ("live_system", "kinds/live", '"live"')), name
    spec = Spec(live_root)
    assert spec.kind(spec.traffic(spec.cell(CELL))).CHECKS == ref.CHECKS
    assert _run(live_root)["correct"] is True


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, trace):
    """``python -m pytest portbench/tests -m card`` on a machine with a
    CUDA card: the cell at its full size through the command."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", CELL, "--seed",
         str(2**31 + 23), "--seconds", "1", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        listed = {m["name"] for m in Spec().metrics(Spec().cell(CELL), "per_layer")}
        assert set(out["metrics"]) >= listed


def _held(*objs) -> dict:
    """The length of every container the objects hold as an attribute."""
    return {f"{type(o).__name__}.{k}": len(v) for o in objs
            for k, v in vars(o).items() if isinstance(v, (dict, list, set, tuple))}


@pytest.mark.card
def test_reset_restores_the_whole_cluster_on_the_card(card):
    """At the cell's own size on the card: a decision memoises on the
    cluster's objects, ``Live.reset`` hands them back equal in every
    attribute, the next decisions answer the same, and what the program
    keeps across decisions does not grow."""
    spec = Spec()
    cell = spec.cell(CELL)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    plain_catalog = gen.catalog(cfg)
    program = live_system.Program(cfg, plain_catalog, traffic)
    inputs = [program.batch(plain) for plain in live.ring(cfg, plain_catalog, traffic, 5)]
    made = [_state(lv._objects) for lv in inputs]
    first = []
    for lv in inputs:
        lv.reset()
        first.append(program.answer(program.decide(lv)[0]))
        assert first[-1]["existing"] and first[-1]["claims"]
    held = None
    for round_ in range(4):
        for i, lv in enumerate(inputs):
            lv.reset()
            assert _state(lv._objects) == made[i]
            assert program.answer(program.decide(lv)[0]) == first[i]
        now = _held(program.solver, *(lv.provisioner for lv in inputs))
        if round_ > 0:
            assert now == held
        held = now
