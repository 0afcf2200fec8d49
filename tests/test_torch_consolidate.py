"""The port's consolidation entry points against the JAX package's.

- **The fleet fixture.** ``perf/configs.py``'s ``config4_consolidation_env
  (24)`` and ``config4_xl_env(96, 4)`` run through the JAX package's own
  ``Environment``; their end states — per-node pod counts by deployment,
  in node order, and the pods' shapes — must equal the port's
  ``underutilized_fleet(24)`` and ``underutilized_fleet(96, 4)``.
- **The three entry points.** One layout is built twice, each time with
  the package's own objects (``KubeStore``, ``Cluster``, ``Provisioner``,
  ``get_candidates``): the port's by ``underutilized_fleet``, the JAX
  package's by ``jax_fleet`` below, the same steps. Then
  ``batched_feasible_prefix`` (the first 100 candidates, built over the
  whole pool), ``batched_single_feasible`` and
  ``joint_retirement_plan(want_singles=True)`` run on each side. Fleets:
  config4 at 24 nodes, xl at 96 × 4, config4 with pending pods (the
  transient path, single rows), config4 with a hostname topology spread
  (``topology-plan``), and config4 under
  ``KARPENTER_REPLACE_MAX_CLAIMS=2``; each with ``KARPENTER_RELAX`` 0 and
  1. Tolerance: exact, compared by name.
"""

import importlib

import pytest

from karpenter_tpu.models.solver import TPUSolver
from karpenter_tpu.ops import consolidate as jcons
from karpenter_tpu_torch.ops import consolidate as tcons
from karpenter_tpu_torch.workload import fleet_layout, underutilized_fleet

GIB = 2**30
MULTI_NODE_CANDIDATE_CAP = 100


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def jax_fleet(layout):
    """``underutilized_fleet`` with the JAX package's objects and a
    ``TPUSolver``: ``(store, cluster, provisioner, cloud, clock)``."""
    pkg = "karpenter_tpu"
    wk = _m(pkg, "api.labels")
    nc = _m(pkg, "api.nodeclaim")
    ob = _m(pkg, "api.objects")
    clock = _m(pkg, "utils.clock").FakeClock()
    store = _m(pkg, "kube.store").KubeStore(clock=clock)
    cloud = _m(pkg, "cloudprovider.kwok").KwokCloudProvider(
        store, [_m(pkg, "cloudprovider.catalog").make_instance_type(
            "xl", 16, 64)])
    pool = _m(pkg, "api.nodepool").NodePool(metadata=ob.ObjectMeta(
        name="default"))
    pool.spec.disruption.consolidate_after = 0.0
    pool.spec.disruption.budgets[0].nodes = "100%"
    store.create("nodepools", pool)
    for i, pods in enumerate(layout):
        name = f"default-{i:05d}"
        claim = cloud.create(nc.NodeClaim(
            metadata=ob.ObjectMeta(name=name, namespace="",
                                   labels={wk.NODEPOOL_LABEL: "default"}),
            spec=nc.NodeClaimSpec(
                requirements=[ob.NodeSelectorRequirement(
                    key=wk.NODEPOOL_LABEL, operator="In",
                    values=["default"])],
                resource_requests={"cpu": 15.0, "memory": 30.0 * GIB,
                                   "pods": 3.0})))
        for cond in (nc.COND_LAUNCHED, nc.COND_REGISTERED,
                     nc.COND_INITIALIZED):
            claim.set_condition(cond)
        store.create("nodeclaims", claim)
        node = store.get("nodes", name)
        node.taints = []
        node.metadata.labels[wk.NODE_REGISTERED_LABEL] = "true"
        node.metadata.labels[wk.NODE_INITIALIZED_LABEL] = "true"
        store.update("nodes", node)
        for deployment, pod_name in pods:
            store.create("pods", ob.Pod(
                metadata=ob.ObjectMeta(
                    name=pod_name, namespace="default",
                    owner_references=[{"kind": "Deployment",
                                       "name": deployment,
                                       "controller": True}]),
                requests={"cpu": 5.0, "memory": 10.0 * GIB},
                node_name=name, phase="Running"))
    cluster = _m(pkg, "state.cluster").Cluster(store, clock=clock)
    for event in store.drain_events():
        cluster.on_event(event)
    prov = _m(pkg, "controllers.provisioning.provisioner").Provisioner(
        store, cloud, solver=TPUSolver(), clock=clock, cluster=cluster)
    return store, cluster, prov, cloud, clock


def apply_variant(pkg, store, cluster, variant):
    """Edit a built fleet into the variant, through the store and the
    cluster's informer entry point."""
    ob = _m(pkg, "api.objects")
    wk = _m(pkg, "api.labels")
    if variant == "pending":
        for i in range(6):
            store.create("pods", ob.Pod(
                metadata=ob.ObjectMeta(name=f"pending-{i}",
                                       namespace="default"),
                requests={"cpu": 5.0, "memory": 10.0 * GIB},
                conditions=[{"type": "PodScheduled", "status": "False",
                             "reason": "Unschedulable"}]))
    elif variant == "spread":
        for pod in store.list("pods"):
            pod.metadata.labels = {"app": "web"}
            pod.topology_spread_constraints = [ob.TopologySpreadConstraint(
                max_skew=1, topology_key=wk.HOSTNAME_LABEL,
                when_unsatisfiable="DoNotSchedule",
                label_selector=ob.LabelSelector(match_labels={"app": "web"}))]
            store.update("pods", pod)
    for event in store.drain_events():
        cluster.on_event(event)


def candidates(pkg, store, cluster, cloud, clock):
    helpers = _m(pkg, "controllers.disruption.helpers")
    return sorted(helpers.get_candidates(cluster, store, cloud, clock),
                  key=lambda c: c.disruption_cost)


def answers(cons, prov, cluster, store, cands):
    """The three entry points' answers, by name."""
    pids = [c.provider_id for c in cands]
    out = {}
    capped = cands[:MULTI_NODE_CANDIDATE_CAP]
    out["prefix"] = cons.batched_feasible_prefix(
        prov, cluster, store, capped, build_candidates=cands)
    single = cons.batched_single_feasible(prov, cluster, store, cands)
    out["single"] = None if single is None else (
        [bool(v) for v in single[0]], single[1])
    plan = cons.joint_retirement_plan(prov, cluster, store, cands,
                                      want_singles=True)
    out["joint"] = None if plan is None else dict(
        viable=plan.viable, reason=plan.reason,
        selected=[pids[i] for i in plan.selected_idx],
        displacement=[tuple(x) for x in plan.displacement],
        overflow=plan.overflow, n_claims=plan.n_claims,
        solver=plan.solver, relax_fallback=plan.relax_fallback,
        definitive=plan.definitive, k_device=plan.k_device,
        single_mask=(None if plan.single_mask is None
                     else [bool(v) for v in plan.single_mask]))
    return out


# fleet: (n_nodes, n_groups, variant)
FLEETS = {
    "config4": (24, None, None),
    "xl": (96, 4, None),
    "pending": (24, None, "pending"),
    "spread": (24, None, "spread"),
    "replace2": (24, None, None),
}


@pytest.mark.parametrize("relax", ["0", "1"])
@pytest.mark.parametrize("fleet", list(FLEETS))
def test_entry_points_match_jax(fleet, relax, monkeypatch):
    monkeypatch.setenv("KARPENTER_RELAX", relax)
    monkeypatch.setenv("KARPENTER_CAPSULE", "0")
    if fleet == "replace2":
        monkeypatch.setenv("KARPENTER_REPLACE_MAX_CLAIMS", "2")
    n_nodes, n_groups, variant = FLEETS[fleet]
    store, cluster, prov, _ = underutilized_fleet(n_nodes, n_groups,
                                                  device="cpu")
    apply_variant("karpenter_tpu_torch", store, cluster, variant)
    tc = candidates("karpenter_tpu_torch", store, cluster, prov.cloud,
                    prov.clock)
    jstore, jcluster, jprov, jcloud, jclock = jax_fleet(
        fleet_layout(n_nodes, n_groups))
    apply_variant("karpenter_tpu", jstore, jcluster, variant)
    jc = candidates("karpenter_tpu", jstore, jcluster, jcloud, jclock)
    assert [c.provider_id for c in tc] == [c.provider_id for c in jc]
    assert [c.price for c in tc] == [c.price for c in jc]

    got = answers(tcons, prov, cluster, store, tc)
    want = answers(jcons, jprov, jcluster, jstore, jc)
    assert got == want

    joint = got["joint"]
    if fleet == "spread":
        assert joint["reason"] == "topology-plan" and not joint["viable"]
        assert got["prefix"] is not None and got["prefix"][1] is False
    elif fleet == "pending":
        # mid-transition: the relax rung is skipped, single rows ride along
        assert joint["solver"] == "ladder" and not joint["relax_fallback"]
        assert joint["single_mask"] is not None
    else:
        assert joint["viable"] and len(joint["selected"]) >= 2
        assert joint["solver"] == ("relax" if relax == "1" else "ladder")
        assert_displacement_feasible(store, joint)


def assert_displacement_feasible(store, joint):
    """The shipped plan, checked against the store itself: no pod lands
    on a retiree, every displaced pod lands, no survivor goes over its
    allocatable."""
    retired = set(joint["selected"])
    nodes = {n.provider_id: n for n in store.list("nodes")}
    used = {pid: {"cpu": 0.0, "memory": 0.0} for pid in nodes}
    displaced = 0
    for p in store.list("pods"):
        pid = f"kwok://{p.node_name}"
        if pid in retired:
            displaced += 1
        elif p.node_name:
            for r in used[pid]:
                used[pid][r] += p.requests[r]
    placed = 0
    for pid, _, count in joint["displacement"]:
        assert pid not in retired
        placed += count
        for r in used[pid]:
            used[pid][r] += count * {"cpu": 5.0, "memory": 10.0 * GIB}[r]
    assert placed + sum(joint["overflow"].values()) == displaced
    for pid, node in nodes.items():
        for r, v in used[pid].items():
            assert v <= node.allocatable[r] + 1e-6


def per_node(store):
    """Per-node pod counts by deployment, in node order, and the set of
    pod shapes."""
    by_node: dict = {}
    shapes = set()
    for p in store.list("pods"):
        dep = p.metadata.owner_references[0]["name"]
        counts = by_node.setdefault(p.node_name, {})
        counts[dep] = counts.get(dep, 0) + 1
        shapes.add(tuple(sorted(p.requests.items())))
    return [by_node.get(n.name, {}) for n in store.list("nodes")], shapes


@pytest.mark.parametrize("n_nodes,n_groups", [(24, None), (96, 4)])
def test_fleet_matches_jax_environment(n_nodes, n_groups):
    from perf.configs import config4_consolidation_env, config4_xl_env

    env = (config4_consolidation_env(n_nodes) if n_groups is None
           else config4_xl_env(n_nodes, n_groups))
    store, cluster, prov, cands = underutilized_fleet(n_nodes, n_groups,
                                                      device="cpu")
    assert per_node(store) == per_node(env.store)
    assert len(cands) == len(store.list("nodes")) == len(
        env.store.list("nodes"))
    assert all(p.node_name for p in store.list("pods"))
    assert prov.solver.device.type == "cpu"
    # the layout's shape: one pod per node, or full and empty nodes
    counts = sorted({sum(c.values()) for c in per_node(store)[0]})
    assert counts == ([1] if n_groups is None else [0, 3])
