"""Existing nodes in the port against the JAX package.

The shapes of ``tests/test_device_existing.py`` — existing capacity
before claims, a full fit, a tainted node, a zone selector, capacity
limits, a daemonset reserve, spread counts and an anti-affinity declarer
seeded from the nodes' current pods, a random mix — are built twice, with
each package's own objects, and solved by ``TPUSolver`` and by
``TorchSolver(device="cpu")``. Tolerance: exact. Every
``ExistingSnapshot`` tensor must be equal, and the solves must give the
same claims (nodepool, pod names, instance-type names), the same pods on
each existing node and the same pod errors.
"""

import importlib
import random

import numpy as np
import pytest

from karpenter_tpu.models.solver import TPUSolver
from karpenter_tpu_torch.models import TorchSolver

jtz = importlib.import_module("karpenter_tpu.ops.tensorize")
ttz = importlib.import_module("karpenter_tpu_torch.ops.tensorize")

GIB = 2**30
ZONES = ("zone-1", "zone-2", "zone-3")
SCENARIOS = ["first_then_claims", "all_fit", "tainted", "selector",
             "capacity", "daemon_reserve", "spread_seeded",
             "anti_declarer", "random_mix"]
ESNAP_ARRAYS = ["e_avail", "ge_ok", "e_npods", "e_scnt", "e_decl",
                "e_match", "e_aff", "live"]


def scenario(pkg: str, name: str):
    """(pods, templates, its, topology, existing_nodes) of one scenario,
    from the package's own objects."""
    m = {k: importlib.import_module(f"{pkg}.{k}") for k in (
        "api.labels", "api.objects", "api.nodepool",
        "cloudprovider.catalog", "models.inflight", "models.existing",
        "models.scheduler", "models.topology", "state.statenode")}
    wk, ob = m["api.labels"], m["api.objects"]

    def pods(n, labels=None, cpu=1.0, prefix="p", **kw):
        return [ob.Pod(metadata=ob.ObjectMeta(name=f"{prefix}{i}",
                                              labels=dict(labels or {})),
                       requests={"cpu": cpu, "memory": 1 * GIB}, **kw)
                for i in range(n)]

    def node(name, cpu=8.0, zone="zone-1", taints=()):
        sn = m["state.statenode"].StateNode(provider_id=f"pid-{name}")
        n = ob.Node(metadata=ob.ObjectMeta(name=name, labels={
            wk.NODEPOOL_LABEL: "default", wk.TOPOLOGY_ZONE_LABEL: zone,
            wk.INSTANCE_TYPE_LABEL: "large",
            wk.CAPACITY_TYPE_LABEL: "on-demand", wk.HOSTNAME_LABEL: name}))
        n.allocatable = {"cpu": cpu, "memory": 32 * GIB, "pods": 110.0}
        n.taints = list(taints)
        sn.node = n
        return sn

    def anti_web():
        return ob.Affinity(pod_anti_affinity=ob.PodAffinity(required=[
            ob.PodAffinityTerm(topology_key=wk.HOSTNAME_LABEL,
                               label_selector=ob.LabelSelector(
                                   match_labels={"app": "web"}))]))

    cat = m["cloudprovider.catalog"]
    pool = m["api.nodepool"].NodePool(metadata=ob.ObjectMeta(name="default"))
    its = {pool.name: [cat.make_instance_type("small", 4, 16, zones=ZONES),
                       cat.make_instance_type("large", 32, 128, zones=ZONES)]}
    topology, daemon = None, None
    if name == "first_then_claims":
        batch, nodes = pods(40), [node("n0"), node("n1")]
    elif name == "all_fit":
        batch, nodes = pods(8), [node("n0")]
    elif name == "tainted":
        batch = pods(4)
        nodes = [node("n0", taints=[ob.Taint("dedicated", "gpu", "NoSchedule")])]
    elif name == "selector":
        batch = pods(4, node_selector={wk.TOPOLOGY_ZONE_LABEL: "zone-2"})
        nodes = [node("n0"), node("n1", zone="zone-2")]
    elif name == "capacity":
        batch, nodes = pods(50, cpu=3.0), [node("n0"), node("n1")]
    elif name == "daemon_reserve":
        batch, nodes = pods(4), [node("n0")]
        daemon = {"cpu": 6.0, "memory": 1 * GIB}
    elif name == "spread_seeded":
        resident = pods(1, {"app": "web"}, prefix="resident")[0]
        sn = node("n0")
        sn.pods[resident.key()] = resident
        batch = pods(3, {"app": "web"}, prefix="sp",
                     topology_spread_constraints=[ob.TopologySpreadConstraint(
                         max_skew=1, topology_key=wk.HOSTNAME_LABEL,
                         when_unsatisfiable="DoNotSchedule",
                         label_selector=ob.LabelSelector(
                             match_labels={"app": "web"}))])
        topology = m["models.topology"].Topology(
            domains={wk.TOPOLOGY_ZONE_LABEL: set(ZONES)}, pods=batch)
        for tg in topology.topologies.values():
            tg.record("n0")
        nodes = [sn]
    elif name == "anti_declarer":
        guard = ob.Pod(metadata=ob.ObjectMeta(name="guard",
                                              labels={"app": "guard"}),
                       requests={"cpu": 1.0, "memory": 1 * GIB},
                       affinity=anti_web())
        sn = node("n0")
        sn.pods[guard.key()] = guard
        batch = pods(2, {"app": "web"}, prefix="w", affinity=anti_web())
        topology = m["models.topology"].Topology(
            domains={wk.TOPOLOGY_ZONE_LABEL: set(ZONES)}, pods=batch)
        topology._update_inverse_anti_affinity(guard, {wk.HOSTNAME_LABEL: "n0"})
        nodes = [sn]
    else:
        r = random.Random(7)
        batch = [ob.Pod(metadata=ob.ObjectMeta(name=f"p{i}"),
                        requests={"cpu": r.choice([0.25, 0.5, 1.0, 2.0]),
                                  "memory": 1 * GIB})
                 for i in range(60)]
        nodes = [node(f"n{j}", zone=ZONES[j]) for j in range(3)]
    topo = topology if topology is not None else m["models.scheduler"].NullTopology()
    enodes = [m["models.existing"].ExistingNode(sn, topo, daemon_resources=daemon)
              for sn in nodes]
    templates = [m["models.inflight"].ClaimTemplate(pool)]
    return batch, templates, its, topology, enodes


def outcome(res, enodes):
    """What a solve decided, by name: claims (nodepool, pods, types),
    pods per existing node, and the pods that failed."""
    claims = [(c.template.nodepool_name, sorted(p.name for p in c.pods),
               sorted(it.name for it in c.instance_types))
              for c in res.new_claims]
    placed = {n.name: sorted(p.name for p in n.pods) for n in enodes}
    return claims, placed, sorted(p.name if hasattr(p, "name") else p
                                  for p in res.pod_errors)


@pytest.mark.parametrize("name", SCENARIOS)
def test_solver_matches_tpu_solver(name):
    jp, jt, jits, jtopo, jnodes = scenario("karpenter_tpu", name)
    tp, tt, tits, ttopo, tnodes = scenario("karpenter_tpu_torch", name)
    jsolver, tsolver = TPUSolver(), TorchSolver(device="cpu")
    jres = jsolver.solve(jp, jt, jits, topology=jtopo, existing_nodes=jnodes)
    tres = tsolver.solve(tp, tt, tits, topology=ttopo, existing_nodes=tnodes)
    assert outcome(tres, tnodes) == outcome(jres, jnodes)
    for key in ("existing_pods", "device_pods", "host_pods", "retry_pods",
                "host_routed"):
        assert tsolver.last_device_stats[key] == jsolver.last_device_stats[key], key
    assert tres.all_pods_scheduled()


@pytest.mark.parametrize("name", SCENARIOS)
def test_tensorize_existing_equal(name):
    """Every ExistingSnapshot tensor, and the padded kernel args with the
    existing-node families, equal on both sides."""
    jp, jt, jits, _, jnodes = scenario("karpenter_tpu", name)
    tp, tt, tits, _, tnodes = scenario("karpenter_tpu_torch", name)
    js = jtz.tensorize(jp, jt, jits)
    ts = ttz.tensorize(tp, tt, tits)
    je = jtz.tensorize_existing(js, jnodes)
    te = ttz.tensorize_existing(ts, tnodes)
    assert te.E == je.E and te.row_of == je.row_of
    for key in ESNAP_ARRAYS:
        a, b = getattr(je, key), getattr(te, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    ja = jtz.kernel_args(js, je)
    ta = ttz.kernel_args(ts, te)
    assert set(ja) == set(ta)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and np.array_equal(ja[k], ta[k]), k
    # E pads to the bucket ladder with an 8-row floor
    assert ta["e_avail"].shape[0] == ttz.bucket(max(te.E, 1), lo=8)


def test_delta_matches_rebuild():
    """apply_delta — a dirty row rebuilt, a node removed, one added —
    lands on the arrays a from-scratch build of the same fleet gives,
    removed rows masked in place, as in the JAX package."""
    tp, tt, tits, _, tnodes = scenario("karpenter_tpu_torch", "random_mix")
    jp, jt, jits, _, jnodes = scenario("karpenter_tpu", "random_mix")
    ts, js = ttz.tensorize(tp, tt, tits), jtz.tensorize(jp, jt, jits)
    te = ttz.tensorize_existing(ts, tnodes[:2])
    je = jtz.tensorize_existing(js, jnodes[:2])
    for nodes in (tnodes, jnodes):
        nodes[0].requests = {"cpu": 3.0}
    te.apply_delta(ts, dirty=[tnodes[0]], removed=["pid-n1"], added=[tnodes[2]])
    je.apply_delta(js, dirty=[jnodes[0]], removed=["pid-n1"], added=[jnodes[2]])
    for key in ESNAP_ARRAYS:
        assert np.array_equal(getattr(je, key), getattr(te, key)), key
    fresh = ttz.tensorize_existing(ts, tnodes)
    live = te.live
    assert list(live) == [True, False, True]
    assert np.array_equal(te.e_avail[live], fresh.e_avail[live])
    assert np.array_equal(te.ge_ok[:, live], fresh.ge_ok[:, live])
    assert not te.ge_ok[:, 1].any() and not te.e_avail[1].any()
