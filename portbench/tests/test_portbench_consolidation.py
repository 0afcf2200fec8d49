"""The consolidation kind on the CPU at a small fleet: the port against the
plain reference, faults planted where the answer is produced, the
control, the generator against the port's own kwok pick, and the layer
readers."""

from __future__ import annotations

import copy
import json
import pickle

import pytest

from portbench import disrupt, fleet, gen, run
from portbench.reference import consolidation as ref
from portbench.reference import consolidation_control as control
from portbench.reference.judge import NODEPOOL
from portbench.spec import Spec
from portbench.tests.conftest import ROOT

CELL = "consolidate-2000"
SEED = 2**31 + 4133
NOOP = {"retired": [], "replacements": [], "placement": {}}


def _setup(small_root):
    spec = Spec(small_root)
    cell = spec.cell(CELL)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    plain_catalog = gen.catalog(cfg)
    return spec, cell, cfg, traffic, plain_catalog, ref.Catalog(cfg, plain_catalog)


def _run(small_root, trace=False, seed=SEED):
    spec, cell, *_ = _setup(small_root)
    return run.run_cell(spec, cell, seed, 0.05, trace, device="cpu")


@pytest.mark.parametrize("seed", [3, 2**33 + 5])
def test_port_is_correct_by_the_reference(small_root, seed, engine):
    _, _, cfg, traffic, plain_catalog, cat = _setup(small_root)
    program = disrupt.Program(cfg, plain_catalog, traffic, "cpu")
    for plain in fleet.ring(cfg, plain_catalog, traffic, seed):
        decision, _ = program.decide(program.batch(plain))
        answer = program.answer(decision)
        assert ref.judge(cfg, cat, plain, answer) == dict.fromkeys(ref.CHECKS, 0)
        assert answer["retired"]
        # every node is spot and the spot-to-spot gate is off: delete only
        assert not answer["replacements"]
        assert ref.cost(cat, plain, answer) < ref.cost(cat, plain, NOOP)
        assert sorted(answer["placement"]) == sorted(
            p for n in plain["nodes"] if n["name"] in answer["retired"] for p in n["pods"])


def test_result_line(small_root):
    spec, cell, *_ = _setup(small_root)
    out = _run(small_root)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["checks"] == {"breaches": {"value": 0, "limit": 0}}
    assert set(out["run"]["breaches"]) == set(ref.CHECKS)
    want = {m["name"] for m in spec.metrics(cell, "end_to_end")}
    assert want == {"decide_p50_ms", "usd_per_kpod_h", "setup_s"}
    assert set(out["metrics"]) == want
    assert out["attempted"] == 10 * 48 * out["run"]["decisions"]
    json.dumps(out)


def test_layer_metrics_read_in_the_cell(small_root, monkeypatch):
    monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")  # the device path
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "0")
    spec, cell, *_ = _setup(small_root)
    out = _run(small_root, trace=True)
    assert out["correct"] is True
    got = out["metrics"]
    new = {"candidates_ms", "snapshot_ms", "global_ms", "relax_ms", "relax_iters"}
    # the confirming solve's layers, which the provisioning cells read too
    solve = {"tensorize_ms", "plan_ms", "lp_floor_ms", "lp_floor_iters",
             "classify_ms", "dispatch_ms", "decode_ms"}
    listed = {m["name"] for m in spec.metrics(cell, "per_layer")}
    assert new | solve <= listed
    # the device trace has nothing to read on the CPU
    assert set(got) == listed - {"kernels_per_decide", "compat_roofline_pct"}
    assert all(got[m]["value"] > 0 for m in new | solve)
    assert got["relax_ms"]["value"] < got["global_ms"]["value"]


def _broken(monkeypatch, fault):
    """Plant ``fault`` where the program's answer is produced."""
    produce = disrupt.answer

    def broken(decision):
        a = produce(decision)
        plain = decision.fleet_plain
        if fault == "unchanged":
            # the fleet handed in comes back: nothing decided
            return copy.deepcopy(NOOP)
        placed = sorted(a["placement"])
        if fault == "half":
            for name in placed[::2]:
                del a["placement"][name]
        elif fault == "pod_left_out":
            del a["placement"][placed[0]]
        elif fault == "extra_retired":
            # one more node retired, its pod placed nowhere
            kept = [n for n in plain["nodes"] if n["name"] not in a["retired"]]
            a["retired"].append(max(kept, key=lambda n: len(n["name"]))["name"])
        elif fault == "overfilled":
            # every displaced pod onto the smallest survivor
            kept = [n["name"] for n in plain["nodes"] if n["name"] not in a["retired"]]
            for name in placed:
                a["placement"][name] = [kept[0]]
        elif fault == "dearer":
            # one node replaced by the dearest type
            node = plain["nodes"][0]
            return {"retired": [node["name"]],
                    "replacements": [{"pool": node["pool"], "pods": node["pods"],
                                      "options": ["fake-it-41"],
                                      "reqs": {NODEPOOL: [False, [node["pool"]]]}}],
                    "placement": {p: ["+0"] for p in node["pods"]}}
        return a

    decide = disrupt.Program.decide

    def keeping(self, batch):
        decision, trace = decide(self, batch)
        decision.fleet_plain = batch.plain
        return decision, trace

    monkeypatch.setattr(disrupt, "answer", broken)
    monkeypatch.setattr(disrupt.Program, "decide", keeping)


@pytest.mark.parametrize("fault", ["unchanged", "half", "pod_left_out",
                                   "extra_retired", "overfilled", "dearer"])
def test_a_broken_timed_path_is_not_correct(small_root, monkeypatch, fault):
    _broken(monkeypatch, fault)
    out = _run(small_root)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["breaches"]["value"] > 0


def test_a_noop_raises_the_bill(small_root, monkeypatch):
    plan = _run(small_root)["metrics"]["usd_per_kpod_h"]["value"]
    _broken(monkeypatch, "unchanged")
    noop = _run(small_root)["metrics"]["usd_per_kpod_h"]["value"]
    assert noop > plan


def test_a_decision_leaves_its_fleet_as_it_was_after_reset(small_root):
    """A decision memoises on the pods; ``Fleet.reset`` hands the next
    decision the fleet as it was made, and it decides the same."""
    _, _, cfg, traffic, plain_catalog, _ = _setup(small_root)
    program = disrupt.Program(cfg, plain_catalog, traffic, "cpu")
    f = program.batch(fleet.ring(cfg, plain_catalog, traffic, 9)[0])

    def state():
        out = []
        for o in f._objects:
            for k, v in o.__dict__.items():
                try:
                    out.append((k, pickle.dumps(v)))
                except (TypeError, pickle.PicklingError):
                    out.append((k, type(v).__name__))
        return out

    made = state()
    first = program.answer(program.decide(f)[0])
    assert state() != made  # the decision memoised on the pods
    f.reset()
    assert state() == made
    assert program.answer(program.decide(f)[0]) == first


def test_fleet_ring_is_deterministic_per_seed(small_root):
    _, _, cfg, traffic, plain_catalog, _ = _setup(small_root)
    seed = 2**31 + 977
    one = fleet.ring(cfg, plain_catalog, traffic, seed)
    assert one == fleet.ring(cfg, plain_catalog, traffic, seed)
    # every seed does the same work: the same fleets, in another order
    other = fleet.ring(cfg, plain_catalog, dict(traffic, ring=4), seed + 1)
    assert sorted(f["index"] for f in other) == [1, 2, 3, 4]
    assert {f["index"]: f for f in other}[one[0]["index"]] == one[0]


def test_node_sizing_is_the_kwok_pick(small_root):
    """Each node is the instance type and offering the port's kwok
    ``create`` picks for a claim of the pool sized for the pods it held."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.nodeclaim import NodeClaim, NodeClaimSpec
    from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, ObjectMeta
    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_tpu_torch.kube.store import KubeStore

    from portbench import system

    _, _, cfg, traffic, plain_catalog, cat = _setup(small_root)
    cloud = KwokCloudProvider(KubeStore(), system.instance_types(cfg, plain_catalog))
    pool = fleet.pool(cfg)["name"]
    plain = fleet.fleet(cfg, cat, traffic, 3)
    assert len({n["type"] for n in plain["nodes"]}) > 5
    for n in plain["nodes"]:
        sized = n["sized_for"]
        claim = cloud.create(NodeClaim(
            metadata=ObjectMeta(name=n["name"], namespace=""),
            spec=NodeClaimSpec(
                requirements=[NodeSelectorRequirement(key=wk.NODEPOOL_LABEL,
                                                      operator="In", values=[pool])],
                resource_requests={"cpu": sized["cpu"], "memory": float(sized["mem"]),
                                   "pods": float(sized["pods"])})))
        labels = claim.metadata.labels
        assert (labels[wk.INSTANCE_TYPE_LABEL], labels[wk.CAPACITY_TYPE_LABEL],
                labels[wk.TOPOLOGY_ZONE_LABEL]) == (n["type"], n["capacity_type"], n["zone"])


def test_fleet_is_a_third_of_what_it_was_sized_for(small_root):
    """Every node holds one replica of each of its deployments, a third of
    the pods its claim was sized for, of upstream's generic shapes."""
    _, _, cfg, traffic, plain_catalog, cat = _setup(small_root)
    plain = fleet.fleet(cfg, cat, traffic, 1)
    pods = {p["name"]: p for p in plain["pods"]}
    d = traffic["deployments_per_node"]
    assert len(plain["nodes"]) == traffic["nodes"] and len(pods) == d * traffic["nodes"]
    for n in plain["nodes"]:
        held = [pods[p] for p in n["pods"]]
        assert len(held) == d and n["sized_for"]["pods"] == 3 * d
        assert n["sized_for"]["mem"] == 3 * sum(p["mem"] for p in held)
        assert n["sized_for"]["cpu"] == pytest.approx(3 * sum(p["cpu"] for p in held))
        assert all(p["cpu"] in traffic["cpus"] and p["mem"] % gen.MIB == 0 for p in held)


@pytest.mark.parametrize("seed", [1, 2, 3, 2**33 + 7])
def test_control_is_not_correct(small_root, seed):
    """The bfloat16 control in the program's place, through the harness's
    own ``run_cell``: ``correct`` false, from its precision alone
    (``capacity``: a node it fills to its bfloat16 limit is overfilled)."""
    spec, cell, *_ = _setup(small_root)
    out = control.run(spec, cell, seed, 0.05, "cpu")
    assert out["correct"] is False, out["checks"]
    assert out["run"]["breaches"]["capacity"] > 0, out["run"]["breaches"]
    assert out["run"]["engines"] == ["control"]


def test_control_in_float64_is_correct(small_root, monkeypatch):
    import torch

    monkeypatch.setattr(control, "LOW", torch.float64)
    spec, cell, *_ = _setup(small_root)
    out = control.run(spec, cell, 5, 0.05, "cpu")
    assert out["correct"] is True, out["run"]["breaches"]
    assert all(out["run"]["ms"])


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, trace):
    """``python -m pytest portbench/tests -m card`` on a machine with a
    CUDA card: the cell at its full size through the command."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", CELL, "--seed",
         str(2**31 + 19), "--seconds", "1", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        listed = {m["name"] for m in Spec().metrics(Spec().cell(CELL), "per_layer")}
        assert set(out["metrics"]) == listed
        assert 0 < out["metrics"]["compat_roofline_pct"]["value"] <= 100


def _held(*objs) -> dict:
    """The length of every container the objects hold as an attribute."""
    return {f"{type(o).__name__}.{k}": len(v) for o in objs
            for k, v in vars(o).items() if isinstance(v, (dict, list, set, tuple))}


@pytest.mark.card
def test_reset_restores_the_whole_fleet_on_the_card(card):
    """At the cell's own size on the card: a decision memoises on the
    fleet's objects, ``Fleet.reset`` hands them back equal in every
    attribute, the next decisions answer the same, and what the program
    keeps across decisions does not grow."""
    spec = Spec()
    cell = spec.cell(CELL)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    plain_catalog = gen.catalog(cfg)
    program = disrupt.Program(cfg, plain_catalog, traffic)
    fleets = [program.batch(plain) for plain in fleet.ring(cfg, plain_catalog, traffic, 5)]

    def state(f):
        out = []
        for o in f._objects:
            for k, v in o.__dict__.items():
                try:
                    out.append((k, pickle.dumps(v)))
                except (TypeError, pickle.PicklingError):
                    out.append((k, type(v).__name__))
        return out

    made = [state(f) for f in fleets]
    first = []
    for f in fleets:
        f.reset()
        first.append(program.answer(program.decide(f)[0]))
        # the budget's 10% of the fleet, deleted: no replacement
        assert len(first[-1]["retired"]) == len(f.plain["nodes"]) // 10
        assert not first[-1]["replacements"]
    held = None
    for round_ in range(4):
        for i, f in enumerate(fleets):
            f.reset()
            assert state(f) == made[i]
            assert program.answer(program.decide(f)[0]) == first[i]
        now = _held(program.solver, *(f.provisioner for f in fleets))
        if round_ > 0:
            assert now == held
        held = now
