"""The spans and the counter of a provisioning round onto a running
cluster, on the CPU: ``topology.count``, ``existing.capacity``,
``existing.topology`` and ``provision.truncate``, the existing-placement
count in
``ops/tensorize.py`` ``STATS``, and the benchmark's readers of them.

A node filled exactly is full, not overfilled: its availability, a
float sum of whole milli-cpu subtracted from its allocatable, may round a
hair below zero, which ``tensorize_existing`` clamps without the
``negative-avail`` anomaly that a real overflow raises.

The round is the live round of ``workload.live_round`` scaled down: a
240-pod headline solved, its claims launched as the running cluster, and
120 pods of the diverse mix on top, solved on the device path
(``KARPENTER_ASSUME_ACCELERATOR=1``, ``KARPENTER_NATIVE_CUTOFF=0``). The
JAX package opens none of these spans; ``tests/test_torch_obs_parity.py``
strips them before it compares the two packages' trees.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from karpenter_tpu_torch import obs, workload
from karpenter_tpu_torch.controllers.provisioning.provisioner import (
    StoreClusterView,
    collect_domains,
)
from karpenter_tpu_torch.kube.store import KubeStore
from karpenter_tpu_torch.models.solver import TorchSolver
from karpenter_tpu_torch.models.topology import Topology
from karpenter_tpu_torch.ops.tensorize import STATS, tensorize, tensorize_existing

READERS = ("topology_count_ms", "existing_capacity_ms", "existing_topology_ms",
           "existing_placed")


@pytest.fixture
def device_path(monkeypatch, tmp_path):
    monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "0")
    monkeypatch.delenv("KARPENTER_PROFILE_DIR", raising=False)
    obs.reset()
    obs.configure(enabled=True, dump_dir=str(tmp_path / "dumps"), capacity=8)
    yield
    obs.reset()


@pytest.fixture(scope="module")
def cluster():
    """The headline's claims as running nodes: (templates, types by pool,
    the claims)."""
    pods, templates, its = workload.build_workload(240, 40)
    res = TorchSolver(device="cpu").solve(pods, templates, its)
    return templates, its, res.new_claims


def _domains(templates, its) -> dict:
    domains: dict = {}
    for t in templates:
        collect_domains(domains, t, its[t.nodepool_name])
    return domains


def _view(claims):
    """A cluster view over a store holding the running nodes and their
    pods, each pod labelled with one of the diverse mix's ``my-label``
    values."""
    store = KubeStore()
    for sn in workload.live_cluster(claims):
        store.create("nodes", sn.node)
        for i, pod in enumerate(sn.pods.values()):
            pod.node_name = sn.node.name
            pod.metadata.labels = {**pod.metadata.labels, "my-label": "abcdefg"[i % 7]}
            store.create("pods", pod)
    return StoreClusterView(store)


def _all(span, name) -> list:
    out = [span] if span.name == name else []
    for c in span.children:
        out += _all(c, name)
    return out


@pytest.mark.parametrize("with_cluster", [False, True], ids=["no-view", "view"])
def test_topology_count_opens_only_with_a_cluster_view(device_path, cluster,
                                                       with_cluster):
    templates, its, claims = cluster
    burst = workload.diverse_pods(120, 7)
    view = _view(claims) if with_cluster else None
    with obs.round_trace("provision") as trace:
        topo = Topology(cluster=view, domains=_domains(templates, its), pods=burst)
    counts = _all(trace.root, "topology.count")
    if not with_cluster:
        assert counts == []
        return
    build = _all(trace.root, "topology.build")
    assert len(build) == 1 and all(c in build[0].children for c in counts)
    # one count per group, and one of the inverse anti-affinities
    assert len(counts) == len(topo.topologies) + 1
    scanned = sorted(c.attrs["pods"] for c in counts)
    want = sorted([sum(1 for _ in view.pods_matching(tg.namespaces, tg.selector))
                   for tg in topo.topologies.values()]
                  + [sum(1 for _ in view.pods_with_anti_affinity())])
    assert scanned == want and max(scanned) > 0


def test_existing_stages_open_once_a_call_and_the_counter_counts(device_path,
                                                                 cluster):
    templates, its, claims = cluster
    burst, topo, nodes = workload.live_round(claims, templates, its, n_pods=120)
    solver = TorchSolver(device="cpu")
    before = dict(STATS)
    with obs.round_trace("provision") as trace:
        solver.solve(burst, templates, its, topology=topo, existing_nodes=nodes)
    stats = solver.last_device_stats
    assert stats["engine"] == "cpu" and stats["existing"] == len(claims)
    calls = _all(trace.root, "tensorize.existing")
    assert len(calls) == 1
    assert [c.name for c in calls[0].children] == ["existing.capacity",
                                                   "existing.topology"]
    assert _all(trace.root, "existing.capacity") == [calls[0].children[0]]
    assert _all(trace.root, "existing.topology") == [calls[0].children[1]]
    after = STATS
    assert stats["existing_pods"] > 0
    assert after["existing_placed"] - before["existing_placed"] == stats["existing_pods"]
    assert after["existing_solves"] - before["existing_solves"] == 1


def test_a_solve_without_existing_nodes_counts_nothing(device_path, cluster):
    templates, its, _ = cluster
    before = dict(STATS)
    with obs.round_trace("provision") as trace:
        TorchSolver(device="cpu").solve(workload.diverse_pods(120, 3), templates, its,
                                        topology=Topology(domains=_domains(templates, its),
                                                          pods=()))
    assert _all(trace.root, "tensorize.existing") == []
    assert (STATS["existing_placed"], STATS["existing_solves"]) == (
        before["existing_placed"], before["existing_solves"])


def _reader(name):
    from portbench.spec import Spec

    return Spec().reader(name)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_where_nothing_was_recorded(name, monkeypatch):
    """A run of a program that opens no such span and keeps no such count
    (the parent of the change that adds them) reads None, and raises
    nothing."""
    ctx = SimpleNamespace(decisions=[{"spans": {"tensorize.existing": 3.0}},
                                     {"spans": {}}, {}])
    for key in ("existing_placed", "existing_solves"):
        monkeypatch.delitem(STATS, key)
    assert _reader(name)(ctx) is None


def test_readers_read_what_was_recorded(monkeypatch):
    ctx = SimpleNamespace(decisions=[
        {"spans": {"topology.count": 4.0, "existing.capacity": 2.0,
                   "existing.topology": 1.0}},
        {"spans": {"topology.count": 6.0, "existing.capacity": 4.0,
                   "existing.topology": 3.0}},
        {"spans": {"topology.count": 8.0, "existing.capacity": 6.0,
                   "existing.topology": 5.0}}])
    monkeypatch.setitem(STATS, "existing_placed", 30)
    monkeypatch.setitem(STATS, "existing_solves", 4)
    assert [_reader(n)(ctx) for n in READERS] == [6.0, 4.0, 3.0, 7.5]
    monkeypatch.setitem(STATS, "existing_solves", 0)
    assert _reader("existing_placed")(ctx) is None


class _State:
    provider_id = "pid-0"
    name = hostname = "n0"
    pods: dict = {}

    def taints(self):
        return []


class _Node:
    """An existing node whose pods request ``used`` cpu of its 0.3."""

    def __init__(self, used):
        from karpenter_tpu_torch.scheduling import Requirements

        self.state_node = _State()
        self.cached_available = {"cpu": 0.3, "memory": 2.0**30}
        self.requests = {"cpu": used}
        self.requirements = Requirements()


@pytest.mark.parametrize("used,fires", [(0.1 + 0.2, False), (0.301, True)],
                         ids=["full", "overfilled"])
def test_only_an_overflow_is_a_negative_availability(device_path, used, fires):
    pods, templates, its = workload.build_workload(8, 4)
    snap = tensorize(pods, templates, its)
    assert 0.3 - used < 0  # 0.1 + 0.2 rounds above 0.3
    before = STATS["negative_avail_total"]
    with obs.round_trace("provision") as trace:
        esnap = tensorize_existing(snap, [_Node(used)])
    assert esnap.e_avail[0].min() == 0.0
    assert STATS["negative_avail_total"] - before == int(fires)
    assert [k for k, _, _ in trace.anomalies] == (["negative-avail"] if fires else [])


def test_provision_truncate_closes_each_schedule(device_path, monkeypatch):
    """The provisioner's round: ``provision.truncate`` once a
    ``Provisioner.schedule``, after the topology and the solve, with the
    count of new claims it truncated and its offering table's
    compatibility lookups, ``compatible`` calls and memo hits as the
    table counts them (cloudprovider/offering_table.py ``STATS``)."""
    from karpenter_tpu_torch.cloudprovider import offering_table
    from tests import test_torch_operator as op

    lookups = []
    compatible = offering_table.OfferingTable._compatible

    def counted(self, reqs, s):
        lookups.append(s)
        return compatible(self, reqs, s)

    monkeypatch.setattr(offering_table.OfferingTable, "_compatible", counted)
    before = dict(offering_table.STATS)
    op._provisioned(op.PORT, "batch-packs")
    traces = obs.RECORDER.traces()
    rounds = [t for t in traces if t.name == "provision"
              and any(c.name == "provision.topology" for c in t.root.children)]
    assert rounds
    for t in rounds:
        names = [c.name for c in t.root.children]
        assert names.count("provision.truncate") == 1
        assert names.index("provision.truncate") > names.index("provision.topology")
        trunc = _all(t.root, "provision.truncate")[0]
        assert trunc.attrs["claims"] >= 1
        assert trunc.attrs["compat_evals"] >= 1
    spans = [sp for t in traces for sp in _all(t.root, "provision.truncate")]
    total = {k: sum(sp.attrs[k] for sp in spans)
             for k in ("claims", "compat_evals", "memo_hits")}
    assert total["compat_evals"] + total["memo_hits"] == len(lookups)
    assert total == {k: offering_table.STATS[k] - before[k] for k in total}
