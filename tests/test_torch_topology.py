"""The topology path of the port against the JAX package.

Seeded topology mixes — zone and hostname spread, hostname and zone pod
affinity, hostname and zone anti-affinity, expression selectors, zone
pins, in the reference benchmark's 7-value label universe — are built
with each package's own objects from one seed and compiled by each
package's waves compiler. Tolerance: exact. The plans must be equal —
device groups (pods by name, in order, extra requirements, caps, class
wiring), host pods and host-routed reasons, the class tensors, and the
tensorized snapshot of the plan.

Then the live round scaled down: a 2,000-pod headline over 60 types
launched as the cluster (``workload.live_cluster``), and 300 pods of the
1/6 constraint mix provisioned onto it with a real ``Topology`` and every
node an ``ExistingNode``. ``TorchSolver(device="cpu")`` must give
``TPUSolver``'s claims, existing-node placements, pod errors and
host-routed reasons, with the same ``ExistingSnapshot`` under the plan.
"""

import importlib
import random

import numpy as np
import pytest

import bench
from karpenter_tpu.models.solver import TPUSolver
from karpenter_tpu_torch.models import TorchSolver

GIB = 2**30
VALUES = ("a", "b", "c", "d", "e", "f", "g")
ZONES = ("zone-1", "zone-2", "zone-3", "zone-4")
N_MIXES = 24
PLAN_ARRAYS = [
    "g_demand", "g_count", "g_mask", "g_has", "g_tol", "g_tmpl_ok",
    "g_zone_allowed", "g_ct_allowed", "g_bin_cap", "g_single", "g_decl",
    "g_match", "g_sown", "g_smatch", "g_aneed", "g_amatch",
]


def _mods(pkg):
    return {k: importlib.import_module(f"{pkg}.{k}") for k in (
        "api.labels", "api.objects", "models.topology", "ops.waves",
        "ops.tensorize")}


def random_mix(pkg: str, seed: int):
    """One seeded mix (the shape of tests/test_waves_parity.py's), from
    the package's own objects. Odd seeds leave out zone anti-affinity,
    which routes every pod its inverse selector matches to the host, so
    that half the mixes keep most groups on the device."""
    m = _mods(pkg)
    wk, ob = m["api.labels"], m["api.objects"]
    r = random.Random(1000 + seed)
    n_pods = r.randrange(20, 120)
    pods = []
    for i in range(n_pods):
        labels = {"my-label": r.choice(VALUES)}
        kw = {}
        kind = r.randrange(8) if seed % 2 == 0 else r.choice((0, 1, 2, 3, 4, 6, 7))

        def sel():
            return ob.LabelSelector(match_labels={"my-label": r.choice(VALUES)})

        if kind == 0:
            kw["topology_spread_constraints"] = [ob.TopologySpreadConstraint(
                max_skew=r.choice((1, 2)), topology_key=wk.TOPOLOGY_ZONE_LABEL,
                when_unsatisfiable="DoNotSchedule",
                min_domains=r.choice((None, None, None, 2)),
                label_selector=sel())]
        elif kind == 1:
            kw["topology_spread_constraints"] = [ob.TopologySpreadConstraint(
                max_skew=r.choice((1, 2, 3)), topology_key=wk.HOSTNAME_LABEL,
                when_unsatisfiable="DoNotSchedule", label_selector=sel())]
        elif kind in (2, 3):
            key = wk.HOSTNAME_LABEL if kind == 2 else wk.TOPOLOGY_ZONE_LABEL
            kw["affinity"] = ob.Affinity(pod_affinity=ob.PodAffinity(required=[
                ob.PodAffinityTerm(topology_key=key, label_selector=sel())]))
        elif kind in (4, 5):
            key = wk.HOSTNAME_LABEL if kind == 4 else wk.TOPOLOGY_ZONE_LABEL
            s = (ob.LabelSelector(match_labels=dict(labels))
                 if kind == 4 and r.random() < 0.5 else sel())
            kw["affinity"] = ob.Affinity(pod_anti_affinity=ob.PodAffinity(
                required=[ob.PodAffinityTerm(topology_key=key,
                                             label_selector=s)]))
        elif kind == 6:
            kw["topology_spread_constraints"] = [ob.TopologySpreadConstraint(
                max_skew=1, topology_key=wk.TOPOLOGY_ZONE_LABEL,
                when_unsatisfiable="DoNotSchedule",
                label_selector=ob.LabelSelector(match_expressions=[
                    ob.NodeSelectorRequirement(
                        "my-label", r.choice(("In", "NotIn", "Exists")),
                        [r.choice(VALUES)])]))]
        if r.random() < 0.2:
            kw["node_selector"] = {wk.TOPOLOGY_ZONE_LABEL: r.choice(ZONES[:3])}
        pods.append(ob.Pod(
            metadata=ob.ObjectMeta(name=f"p{i}", labels=dict(labels)),
            requests={"cpu": r.choice((0.1, 0.25, 0.5, 1.0)),
                      "memory": r.choice((0.25, 0.5, 1.0)) * GIB},
            **kw))
    domains = {wk.TOPOLOGY_ZONE_LABEL: set(ZONES[: r.choice((2, 3, 4))])}
    return pods, domains


def compile_plan(pkg: str, seed: int, vectorized=None):
    m = _mods(pkg)
    tz = m["ops.tensorize"]
    pods, domains = random_mix(pkg, seed)
    topo = m["models.topology"].Topology(domains=domains, pods=pods)
    basic = [p for p in pods if tz.device_basic_eligible(p)]
    return m["ops.waves"].compile_topology(
        tz.group_by_signature(basic), topo, vectorized=vectorized)


def plan_signature(plan):
    """A WavesPlan by value: pods by name and order, each group field by
    field, host routing, the class wiring by topology-group key."""
    def tg_key(tg):
        return None if tg is None else tg.hash_key()

    return (
        [([p.name for p in dg.pods],
          sorted((r.key, r.complement, tuple(sorted(r.values)),
                  r.greater_than, r.less_than) for r in dg.extra_reqs),
          dg.bin_cap, dg.single_bin, sorted(dg.decl_classes),
          sorted(dg.match_classes), sorted(dg.spread_caps.items()),
          sorted(dg.spread_matches), sorted(dg.aff_need),
          sorted(dg.aff_match))
         for dg in plan.device_groups],
        [p.name for p in plan.host_pods],
        plan.n_classes, plan.n_spread_classes, plan.n_aff_classes,
        [(tg_key(d), tg_key(i)) for d, i in plan.anti_tgs_by_class],
        [tg_key(x) for x in plan.spread_tgs_by_class],
        [tg_key(x) for x in plan.aff_tgs_by_class],
        dict(plan.host_reasons),
    )


def _tensors(plan):
    return (*plan.class_masks(), *plan.spread_tensors(), *plan.aff_tensors())


@pytest.mark.parametrize("seed", range(N_MIXES))
def test_compile_topology_matches_jax(seed):
    jplan = compile_plan("karpenter_tpu", seed)
    tplan = compile_plan("karpenter_tpu_torch", seed)
    assert plan_signature(tplan) == plan_signature(jplan)
    for a, b in zip(_tensors(jplan), _tensors(tplan)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_sequential_oracle_matches(seed, monkeypatch):
    """KARPENTER_WAVES_SEQUENTIAL=1 selects the port's sequential oracle,
    which gives the vectorized compiler's plan."""
    monkeypatch.setenv("KARPENTER_WAVES_SEQUENTIAL", "1")
    seq = compile_plan("karpenter_tpu_torch", seed)
    monkeypatch.delenv("KARPENTER_WAVES_SEQUENTIAL")
    vec = compile_plan("karpenter_tpu_torch", seed)
    assert plan_signature(seq) == plan_signature(vec)


@pytest.mark.parametrize("seed", range(0, N_MIXES, 6))
def test_tensorize_device_plan_matches_jax(seed):
    """The plan's snapshot: group rows with the plan's extra requirements,
    caps and class tensors, equal array by array."""
    snaps = []
    for pkg, build in (("karpenter_tpu", bench.build_workload),
                       ("karpenter_tpu_torch",
                        importlib.import_module(
                            "karpenter_tpu_torch.workload").build_workload)):
        _, templates, its = build(10, 30)
        plan = compile_plan(pkg, seed)
        snaps.append(_mods(pkg)["ops.tensorize"].tensorize(
            None, sorted(templates, key=lambda t: (-t.weight, t.nodepool_name)),
            its, device_plan=plan))
    js, ts = snaps
    assert ts.keys == js.keys and ts.vocab == js.vocab
    assert [[p.name for p in g] for g in ts.groups] == [
        [p.name for p in g] for g in js.groups]
    for name in PLAN_ARRAYS:
        a, b = getattr(js, name), getattr(ts, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


# ---- the live round, scaled down ----------------------------------------

N_HEADLINE, N_TYPES, N_BURST = 2000, 60, 300


def _jax_cluster(port_nodes, jax_pods):
    """The port's live cluster rebuilt from the JAX package's objects:
    same names, labels, capacity and allocatable, the same pods (by name)
    bound."""
    from karpenter_tpu.api.objects import Node, ObjectMeta
    from karpenter_tpu.state.statenode import StateNode

    by_name = {p.name: p for p in jax_pods}
    out = []
    for tsn in port_nodes:
        sn = StateNode(provider_id=tsn.provider_id)
        tn = tsn.node
        sn.node = Node(metadata=ObjectMeta(name=tn.name, labels=dict(tn.labels)),
                       provider_id=tn.provider_id, capacity=dict(tn.capacity),
                       allocatable=dict(tn.allocatable))
        for tp in tsn.pods.values():
            p = by_name[tp.name]
            p.node_name = tn.name
            sn.pods[p.key()] = p
        out.append(sn)
    return out


def _jax_round(port_nodes, jax_pods, templates, its):
    from karpenter_tpu.controllers.provisioning.provisioner import collect_domains
    from karpenter_tpu.models.existing import ExistingNode
    from karpenter_tpu.models.topology import Topology
    from perf.configs import diverse_pods

    burst = diverse_pods(N_BURST, 42)
    domains: dict = {}
    for t in templates:
        collect_domains(domains, t, its[t.nodepool_name])
    topology = Topology(domains=domains, pods=burst)
    existing = [ExistingNode(sn, topology)
                for sn in _jax_cluster(port_nodes, jax_pods)]
    return burst, topology, existing


@pytest.fixture(scope="module")
def headline():
    """The scaled-down headline on each side: the port's solve (its
    claims become the cluster) and the JAX package's own pods."""
    from karpenter_tpu_torch import workload

    tpods, ttemplates, tits = workload.build_workload(N_HEADLINE, N_TYPES)
    jpods, jtemplates, jits = bench.build_workload(N_HEADLINE, N_TYPES)
    res = TorchSolver(device="cpu").solve(tpods, ttemplates, tits)
    return res, (ttemplates, tits), (jpods, jtemplates, jits)


def _rounds(headline):
    from karpenter_tpu_torch import workload

    res, (ttemplates, tits), (jpods, jtemplates, jits) = headline
    tburst, ttopo, tnodes = workload.live_round(
        res.new_claims, ttemplates, tits, n_pods=N_BURST)
    jburst, jtopo, jnodes = _jax_round(
        [n.state_node for n in tnodes], jpods, jtemplates, jits)
    assert [p.name for p in tburst] == [p.name for p in jburst]
    return ((tburst, ttemplates, tits, ttopo, tnodes),
            (jburst, jtemplates, jits, jtopo, jnodes))


def test_live_round_existing_snapshot_matches(headline):
    """Under the round's waves plan, the snapshot and the existing-node
    tensors (class counts seeded from each node's hostname domain) are
    equal on both sides."""
    sides = []
    for pkg, (burst, templates, its, topo, nodes) in zip(
            ("karpenter_tpu_torch", "karpenter_tpu"), _rounds(headline)):
        tz = _mods(pkg)["ops.tensorize"]
        basic = [p for p in burst if tz.device_basic_eligible(p)]
        plan = _mods(pkg)["ops.waves"].compile_topology(
            tz.group_by_signature(basic), topo)
        tpl = sorted(templates, key=lambda t: (-t.weight, t.nodepool_name))
        snap = tz.tensorize(None, tpl, its, device_plan=plan)
        sides.append((plan, snap, tz.tensorize_existing(snap, nodes, plan)))
    (tplan, ts, te), (jplan, js, je) = sides
    assert plan_signature(tplan) == plan_signature(jplan)
    for name in PLAN_ARRAYS:
        assert np.array_equal(getattr(js, name), getattr(ts, name)), name
    for key in ("e_avail", "ge_ok", "e_npods", "e_scnt", "e_decl",
                "e_match", "e_aff"):
        a, b = getattr(je, key), getattr(te, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert te.E == len(headline[0].new_claims)


def test_live_round_matches_tpu_solver(headline):
    (tburst, ttemplates, tits, ttopo, tnodes), (
        jburst, jtemplates, jits, jtopo, jnodes) = _rounds(headline)
    jsolver, tsolver = TPUSolver(), TorchSolver(device="cpu")
    jres = jsolver.solve(jburst, jtemplates, jits, topology=jtopo,
                         existing_nodes=jnodes)
    tres = tsolver.solve(tburst, ttemplates, tits, topology=ttopo,
                         existing_nodes=tnodes)

    def outcome(res, nodes):
        return ([(c.template.nodepool_name, sorted(p.name for p in c.pods),
                  sorted(it.name for it in c.instance_types))
                 for c in res.new_claims],
                {n.name: sorted(p.name for p in n.pods) for n in nodes},
                sorted(p.name for p in res.pod_errors))

    assert outcome(tres, tnodes) == outcome(jres, jnodes)
    ts_, js_ = tsolver.last_device_stats, jsolver.last_device_stats
    for key in ("groups", "existing_pods", "device_pods", "host_pods",
                "retry_pods", "host_routed"):
        assert ts_[key] == js_[key], key
    assert ts_["existing"] == len(tnodes) == headline[0].node_count()
    assert ts_["groups"] > 100 and ts_["existing_pods"] > 0
