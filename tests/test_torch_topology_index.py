"""The topology counts from the index of the running pods, on the CPU.

``Topology._count_domains`` counts every group's domains from one index
of the cluster view's running pods (``models/topology.py``). Its counts
are held, group by group, to the per-pod scan kept here as the plain
reference (``ScanTopology``) and to the JAX package's ``Topology`` over
the same view: the domain map in its insertion order and the empty
domains. Tolerance: exact.

The cluster: three namespaces, two of them labelled ``team=x``; nine
nodes over three zones, one without the hostname label, all but one
with a numeric ``gen`` label; 90 running pods
of three ``my-label`` values, some with a second label, interleaved over
the nodes, and pods the counts skip (unbound, ``Succeeded``, ``Failed``,
terminating). The store view also holds pods bound to a node the store
does not have. Each case adds pending pods whose groups exercise one
path of the count; both views are run.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import pytest

from karpenter_tpu.models import topology as jax_topology
from karpenter_tpu_torch.admission.fork import fork_topology
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api import objects as ob
from karpenter_tpu_torch.controllers.provisioning.provisioner import (
    ClusterStateView,
    StoreClusterView,
)
from karpenter_tpu_torch.kube.store import KubeStore
from karpenter_tpu_torch.models import topology
from karpenter_tpu_torch.models.topology import Topology, ignored_for_topology
from karpenter_tpu_torch.state.cluster import Cluster

VALUES = ("a", "b", "c")
ZONES = ("zone-1", "zone-2", "zone-3")
NODES = tuple(f"node-{i}" for i in range(9))
NO_HOSTNAME = "node-4"
NO_GEN = "node-2"
# zone-3 is left out, so its domain enters the maps where it is first counted
DOMAINS = {wk.TOPOLOGY_ZONE_LABEL: {"zone-1", "zone-2"}}


class ScanTopology(Topology):
    """The plain reference: each group's count walks the view's pods of
    its namespaces and selector one by one."""

    def _count_domains(self, tg):
        if self.cluster is None:
            return
        for pod, node_labels in self.cluster.pods_matching(tg.namespaces, tg.selector):
            if ignored_for_topology(pod) or pod.uid in self.excluded_pods:
                continue
            domain = (node_labels or {}).get(tg.key)
            if domain is None and tg.key == wk.HOSTNAME_LABEL:
                domain = pod.node_name
            if domain is None:
                continue
            if not tg.node_filter.matches_labels(node_labels or {}):
                continue
            tg.record(domain)


def _store():
    store = KubeStore()
    for name, team in (("default", "x"), ("other", "x"), ("third", "y")):
        store.create("namespaces", SimpleNamespace(
            metadata=ob.ObjectMeta(name=name, namespace="", labels={"team": team})))
    for i, name in enumerate(NODES):
        labels = {wk.TOPOLOGY_ZONE_LABEL: ZONES[i % 3], "pool": f"p{i % 2}"}
        if name != NO_GEN:
            labels["gen"] = str(i + 1)
        if name != NO_HOSTNAME:
            labels[wk.HOSTNAME_LABEL] = name
        store.create("nodes", ob.Node(metadata=ob.ObjectMeta(name=name, labels=labels),
                                      provider_id=f"kwok://{name}"))
    r = random.Random(7)
    for i in range(90):
        labels = {"my-label": r.choice(VALUES)}
        if i % 4 == 0:
            labels["tier"] = "web"
        kw = {"node_name": r.choice(NODES), "phase": "Running"}
        if i % 11 == 3:
            kw["node_name"] = ""
            kw["phase"] = "Pending"
        elif i % 11 == 5:
            kw["phase"] = r.choice(("Succeeded", "Failed"))
        elif i % 11 == 7:
            kw["terminating"] = True
        store.create("pods", ob.Pod(
            metadata=ob.ObjectMeta(name=f"run-{i}", namespace=("default", "other", "third")[i % 3],
                                   labels=labels),
            requests={"cpu": 0.1}, **kw))
    return store


def _view(kind: str):
    store = _store()
    if kind == "store":
        for i in range(3):
            store.create("pods", ob.Pod(
                metadata=ob.ObjectMeta(name=f"ghost-{i}", labels={"my-label": VALUES[i]}),
                node_name="ghost-node", phase="Running", requests={"cpu": 0.1}))
        return StoreClusterView(store)
    cluster = Cluster(store)
    for event in store.drain_events():
        cluster.on_event(event)
    return ClusterStateView(cluster, store)


def _sel(**match_labels):
    return ob.LabelSelector(match_labels=match_labels)


def _expr(key, op, *values):
    return ob.LabelSelector(match_expressions=[ob.NodeSelectorRequirement(key, op, list(values))])


def _spread(key, selector, **kw):
    return ob.TopologySpreadConstraint(max_skew=1, topology_key=key,
                                       when_unsatisfiable="DoNotSchedule",
                                       label_selector=selector, **kw)


def _affinity(key, selector, **kw):
    return ob.Affinity(pod_affinity=ob.PodAffinity(
        required=[ob.PodAffinityTerm(topology_key=key, label_selector=selector, **kw)]))


def _node_affinity(key, op, *values):
    # the term's expression in its dict form, which the JAX package's node
    # filter also reads
    return ob.Affinity(node_affinity=ob.NodeAffinity(required=[
        ob.NodeSelectorTerm([{"key": key, "operator": op, "values": list(values)}])]))


def _pod(name, **kw):
    return ob.Pod(metadata=ob.ObjectMeta(name=name, labels={"my-label": "a"}),
                  requests={"cpu": 0.1}, **kw)


ZONE, HOST = wk.TOPOLOGY_ZONE_LABEL, wk.HOSTNAME_LABEL

CASES = {
    "spread": lambda: [
        _pod("p0", topology_spread_constraints=[_spread(ZONE, _sel(**{"my-label": "a"}))]),
        _pod("p1", topology_spread_constraints=[_spread(HOST, _sel(**{"my-label": "b"}))]),
        _pod("p2", topology_spread_constraints=[_spread(HOST, _sel(**{"my-label": "a"})),
                                                _spread(ZONE, _sel(**{"my-label": "c"}))]),
    ],
    "namespaces": lambda: [
        _pod("p0", affinity=_affinity(ZONE, _sel(**{"my-label": "b"}),
                                      namespaces=["default", "other"])),
        _pod("p1", affinity=_affinity(HOST, _sel(**{"my-label": "c"}), namespaces=["third"])),
    ],
    "namespace-selector": lambda: [
        _pod("p0", affinity=_affinity(ZONE, _sel(**{"my-label": "a"}),
                                      namespace_selector=_sel(team="x"))),
        _pod("p1", affinity=_affinity(HOST, _sel(**{"my-label": "b"}), namespaces=["third"],
                                      namespace_selector=_sel(team="x"))),
    ],
    "none-selector": lambda: [
        _pod("p0", topology_spread_constraints=[_spread(ZONE, None)]),
        _pod("p1", affinity=_affinity(HOST, None, namespaces=["other", "third"])),
    ],
    "ignored": lambda: [
        _pod("p0", affinity=_affinity(HOST, _expr("my-label", "Exists"),
                                      namespaces=["default", "other", "third"])),
    ],
    "no-hostname": lambda: [
        _pod("p0", topology_spread_constraints=[_spread(HOST, _sel(**{"my-label": "c"}))]),
        _pod("p1", affinity=_affinity(HOST, _sel(tier="web"))),
    ],
    "node-filter": lambda: [
        _pod("p0", topology_spread_constraints=[_spread(ZONE, _sel(**{"my-label": "a"}))],
             # the terms' expressions in their dict form, which the JAX
             # package's node filter also reads
             affinity=ob.Affinity(node_affinity=ob.NodeAffinity(required=[
                 ob.NodeSelectorTerm([{"key": ZONE, "operator": "In",
                                       "values": ["zone-1", "zone-3"]}]),
                 ob.NodeSelectorTerm([{"key": "pool", "operator": "In", "values": ["p1"]}])]))),
        # a second filter over the same pods, whose verdicts differ
        _pod("p1", topology_spread_constraints=[_spread(HOST, _sel(**{"my-label": "a"}))],
             node_selector={"pool": "p1"}),
        # Gt, Lt and Exists on one key: filters that differ only in their
        # bounds, on groups of different selectors over the same pods
        _pod("p2", topology_spread_constraints=[_spread(ZONE, _expr("my-label", "In", "a", "b"))],
             affinity=_node_affinity("gen", "Gt", "2")),
        _pod("p3", topology_spread_constraints=[_spread(ZONE, _expr("my-label", "NotIn", "c"))],
             affinity=_node_affinity("gen", "Gt", "5")),
        _pod("p4", topology_spread_constraints=[_spread(ZONE, _expr("my-label", "Exists"))],
             affinity=_node_affinity("gen", "Lt", "8")),
        _pod("p5", topology_spread_constraints=[_spread(ZONE, _expr("my-label", "In", "a"))],
             affinity=_node_affinity("gen", "Exists")),
    ],
    "two-signatures": lambda: [
        _pod("p0", topology_spread_constraints=[_spread(HOST, _expr("my-label", "In", "a", "b"))]),
        _pod("p1", affinity=_affinity(ZONE, _expr("my-label", "NotIn", "c"))),
    ],
}


def _groups(topo) -> list:
    return [(list(tg.domains.items()), set(tg.empty_domains))
            for tgs in (topo.topologies, topo.inverse_topologies) for tg in tgs.values()]


def _excluded(view) -> list:
    """Two running pods of each namespace, as a disruption simulation
    hands the candidates' pods to its ``Topology``."""
    pods = [p for p, _ in view.pods_matching(frozenset({"default", "other", "third"}), None)
            if not ignored_for_topology(p)]
    return pods[::9][:6]


@pytest.mark.parametrize("excluded", [False, True], ids=["all", "excluded"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["state", "store"])
def test_indexed_counts_equal_the_scan_and_the_jax_package(kind, case, excluded):
    view = _view(kind)
    pending = CASES[case]()
    pods = pending + (_excluded(view) if excluded else [])
    topo = Topology(cluster=view, domains=DOMAINS, pods=pods)
    want = _groups(ScanTopology(cluster=view, domains=DOMAINS, pods=pods))
    assert _groups(topo) == want
    assert _groups(jax_topology.Topology(cluster=view, domains=DOMAINS, pods=pods)) == want
    # something was counted, and a group read pods the index skips
    assert sum(n for domains, _ in want for _, n in domains) > 0


@pytest.mark.parametrize("kind", ["state", "store"])
def test_a_fork_counts_its_new_groups_from_the_shared_index(kind):
    view = _view(kind)
    pending = CASES["spread"]() + CASES["two-signatures"]()
    late = _pod("late", topology_spread_constraints=[_spread(ZONE, _sel(tier="web"))],
                affinity=_affinity(HOST, _expr("my-label", "In", "b", "c")))
    topo = Topology(cluster=view, domains=DOMAINS, pods=pending)
    ref = ScanTopology(cluster=view, domains=DOMAINS, pods=pending)
    before = _groups(topo)
    walks = topology.STATS["index_walks"]
    fork, ref_fork = fork_topology(topo), fork_topology(ref)
    fork.update(late)
    ref_fork.update(late)
    assert _groups(fork) == _groups(ref_fork)
    assert len(fork.topologies) == len(topo.topologies) + 2
    assert topology.STATS["index_walks"] == walks  # one namespace set, walked once
    assert _groups(topo) == before


def test_each_namespace_set_is_walked_once():
    view = _view("state")
    before = dict(topology.STATS)
    pods = CASES["namespaces"]() + CASES["spread"]()
    topo = Topology(cluster=view, domains=DOMAINS, pods=pods)
    sets = {tg.namespaces for tg in topo.topologies.values()}
    walked = sum(sum(1 for _ in view.pods_matching(ns, None)) for ns in sets)
    delta = {k: topology.STATS[k] - before[k] for k in before}
    assert delta["counts"] == len(topo.topologies)
    assert delta["index_walks"] == len(sets) == 3
    assert delta["pods_walked"] == walked
    assert 0 < delta["selector_tests"] <= len(topo.topologies) * walked
