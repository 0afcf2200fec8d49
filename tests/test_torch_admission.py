"""The port's admission plane against the JAX package's.

Every scenario is written once and built twice, each time from one
package's own objects (one seed, the same draws), and run through that
package's code: the JAX package with ``TPUSolver`` on the CPU
(``KARPENTER_NATIVE_CUTOFF=0``, as its tests pin it), the port with
``TorchSolver(device="cpu")``. Tolerance: exact for every integer and
every decision.

- **The tier split**: ``tensorize(..., tier_of=...)`` gives the same
  ``g_tier``, ``n_tiers``, group order, row keys, snapshot arrays and
  kernel args; ``solve_step`` on them gives the same ``assign``, ``used``,
  ``tmpl`` and ``tier``; ``TorchSolver.solve(tier_of=)`` the same claims
  and ``claim._tier``.
- **The round**: ``AdmissionPlane.solve_round`` gives the same claims
  (pods per claim by name, instance-type sets), the same ``pod_errors``
  keys and the same ``report`` on seeded mixes of the shapes of
  ``tests/test_fused_round.py`` (fused, cascade with the knob off, gang
  rounds) and ``tests/test_priority_admission.py`` (cascade-vs-oracle
  mixes, tier order under a limit, starved and quorum-less gangs,
  co-located gangs), and the port's host rung equals its tiered-FFD
  oracle.
- **Preemption**: ``probe_feasible_batch`` equals the per-preemptor
  ``probe_feasible`` and the JAX package's; ``preempt_env`` run through
  both ``Environment``s evicts the same victims and binds the same
  pods, and so do the Never/PDB exemptions.
- **The provisioner** routes a marked batch through the plane instead
  of refusing it.
- **The fault rule**: a host-side error in a gang trial routes the gang,
  a kernel fault propagates.
"""

from __future__ import annotations

import importlib
import random

import numpy as np
import pytest

from karpenter_tpu.models.solver import HostSolver as JaxHostSolver
from karpenter_tpu.models.solver import TPUSolver
from karpenter_tpu_torch.models.solver import HostSolver as PortHostSolver
from karpenter_tpu_torch.models.solver import TorchSolver

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"
GIB = 2**30


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def solver_of(pkg, host=False):
    if host:
        return JaxHostSolver() if pkg == JAX else PortHostSolver()
    return TPUSolver() if pkg == JAX else TorchSolver(device="cpu")


def _pod(pkg, name, cpu=1.0, mem=2.0, **kw):
    ob = mod(pkg, "api.objects")
    return ob.Pod(metadata=ob.ObjectMeta(
        name=name, labels=kw.pop("labels", {}),
        annotations=kw.pop("annotations", {})),
        requests={"cpu": cpu, "memory": mem * GIB}, **kw)


def _pool(pkg, limits_cpu=None):
    ob = mod(pkg, "api.objects")
    pool = mod(pkg, "api.nodepool").NodePool(
        metadata=ob.ObjectMeta(name="default"))
    if limits_cpu is not None:
        pool.spec.limits = {"cpu": limits_cpu}
    return pool


def _inputs(pkg, pods, catalog, pools=None):
    pools = pools or [_pool(pkg)]
    templates = [mod(pkg, "models").ClaimTemplate(p) for p in pools]
    its = {p.name: catalog for p in pools}
    domains: dict = {}
    collect = mod(pkg, "controllers.provisioning.provisioner").collect_domains
    for t in templates:
        collect(domains, t, catalog)
    topo = mod(pkg, "models.topology").Topology(domains=domains, pods=pods)
    return templates, its, topo


# ---------------------------------------------------------------------------
# seeded mixes (one draw sequence, either package's objects)
# ---------------------------------------------------------------------------

def loose_mix(pkg, seed):
    """``tests/test_fused_round.py``'s gang-free mix."""
    r = random.Random(seed)
    catalog = mod(pkg, "cloudprovider.catalog").benchmark_catalog(
        r.choice((4, 8, 12)))
    pods = []
    for i in range(r.randint(8, 28)):
        p = _pod(pkg, f"f{seed}-{i}", cpu=r.choice((0.25, 0.5, 1.0, 2.0)),
                 mem=r.choice((0.5, 1.0, 2.0)))
        p.priority = r.choice((0, 0, 100, 1000, 5000))
        pods.append(p)
    return pods, catalog, None, None


def gang_mix_small(pkg, seed):
    """``tests/test_priority_admission.py``'s seeded mix: loose tiers plus
    up to two gangs, half co-located on the zone, some below quorum."""
    wk = mod(pkg, "api.labels")
    r = random.Random(seed)
    catalog = mod(pkg, "cloudprovider.catalog").benchmark_catalog(
        r.choice((4, 8, 12)))
    pods = []
    n = r.randint(8, 28)
    n_gangs = r.randint(0, 2)
    for i in range(n):
        p = _pod(pkg, f"p{seed}-{i}", cpu=r.choice((0.25, 0.5, 1.0, 2.0)),
                 mem=r.choice((0.5, 1.0, 2.0)))
        p.priority = r.choice((0, 0, 100, 1000, 5000))
        pods.append(p)
    for g in range(n_gangs):
        size = r.randint(2, 5)
        annotations = {wk.POD_GROUP_ANNOTATION: f"g{seed}-{g}"}
        if r.random() < 0.5:
            annotations[wk.POD_GROUP_TOPOLOGY_ANNOTATION] = (
                wk.TOPOLOGY_ZONE_LABEL)
        if r.random() < 0.2:
            annotations[wk.POD_GROUP_MIN_ANNOTATION] = str(size + 3)
        for i in range(size):
            p = _pod(pkg, f"p{seed}-g{g}-{i}", cpu=1.0, mem=1.0,
                     annotations=dict(annotations))
            p.priority = r.choice((0, 1000))
            pods.append(p)
    return pods, catalog, None, None


def tier_fence(pkg, _seed):
    """One node's worth of limit-admissible capacity, two tiers."""
    catalog = [mod(pkg, "cloudprovider.catalog").make_instance_type(
        "xl", 8, 32)]
    pods = []
    for prio, tag in ((1000, "hi"), (0, "lo")):
        for i in range(8):
            p = _pod(pkg, f"{tag}{i}", cpu=1.0, mem=1.0)
            p.priority = prio
            pods.append(p)
    return pods, catalog, [_pool(pkg, "8")], {"default": {"cpu": 8.0}}


def starved_gang(pkg, seed):
    """``TestGangAtomicity``'s starved-budget fuzz case."""
    wk = mod(pkg, "api.labels")
    r = random.Random(1000 + seed)
    catalog = [mod(pkg, "cloudprovider.catalog").make_instance_type(
        "m", 4, 16)]
    cap = r.choice((4.0, 8.0, 12.0))
    gang_size = r.randint(2, 8)
    pods = [_pod(pkg, f"s{seed}-g{i}", cpu=2.0, mem=2.0,
                 annotations={wk.POD_GROUP_ANNOTATION: "gang"})
            for i in range(gang_size)]
    for i in range(r.randint(0, 4)):
        pods.append(_pod(pkg, f"s{seed}-l{i}", cpu=1.0, mem=1.0))
    return pods, catalog, None, {"default": {"cpu": cap}}


def quorum_gang(pkg, _seed):
    wk = mod(pkg, "api.labels")
    catalog = [mod(pkg, "cloudprovider.catalog").make_instance_type(
        "m", 8, 32)]
    ann = {wk.POD_GROUP_ANNOTATION: "mpi", wk.POD_GROUP_MIN_ANNOTATION: "4"}
    pods = [_pod(pkg, f"g{i}", cpu=1.0, mem=1.0, annotations=dict(ann))
            for i in range(3)]
    return pods, catalog, None, None


def colocated_gang(pkg, _seed):
    wk = mod(pkg, "api.labels")
    catalog = mod(pkg, "cloudprovider.catalog").benchmark_catalog(
        6, zones=("zone-1", "zone-2"))
    ann = {wk.POD_GROUP_ANNOTATION: "adj",
           wk.POD_GROUP_TOPOLOGY_ANNOTATION: wk.TOPOLOGY_ZONE_LABEL}
    pods = [_pod(pkg, f"g{i}", cpu=1.0, mem=1.0, annotations=dict(ann))
            for i in range(4)]
    return pods, catalog, None, None


def round_shape(res) -> tuple:
    """Claims (pool, pod names, instance-type names) sorted, existing
    nodes' scheduled pods, the error keys."""
    claims = sorted(
        (c.template.nodepool_name, tuple(sorted(p.name for p in c.pods)),
         tuple(sorted(it.name for it in c.instance_types)))
        for c in res.new_claims if c.pods)
    existing = sorted(
        tuple(sorted(p.name for p in getattr(n, "scheduled_pods", []) or []))
        for n in res.existing_nodes)
    return claims, existing, sorted(res.pod_errors)


def solve_round(pkg, build, seed, host=False):
    pods, catalog, pools, limits = build(pkg, seed)
    templates, its, topo = _inputs(pkg, pods, catalog, pools)
    plane = mod(pkg, "admission").AdmissionPlane()
    return plane.solve_round(
        solver_of(pkg, host), [p.clone() for p in pods], templates, its,
        topology=topo, limits=limits)


def same_report(got, want):
    """The port's report carries every key of the JAX package's, equal;
    its own additions (probe counts, gang route reasons) stand in for the
    decision ledger."""
    assert {k: got[k] for k in want} == want


ROUNDS = (
    [("fused", loose_mix, s) for s in range(8)]
    + [("gangs", gang_mix_small, s) for s in range(10)]
    + [("starved", starved_gang, s) for s in range(6)]
    + [("tier-fence", tier_fence, 0), ("quorum", quorum_gang, 0),
       ("colocated", colocated_gang, 0)]
)


@pytest.mark.parametrize("name,build,seed", ROUNDS,
                         ids=[f"{n}-{s}" for n, _, s in ROUNDS])
@pytest.mark.parametrize("fused", ["fused-on", "fused-off"])
def test_solve_round_matches_jax(name, build, seed, fused, monkeypatch):
    monkeypatch.setenv("KARPENTER_FUSED_ROUND",
                       "1" if fused == "fused-on" else "0")
    got = solve_round(PORT, build, seed)
    want = solve_round(JAX, build, seed)
    assert round_shape(got) == round_shape(want)
    same_report(got.admission, want.admission)
    gang_free = not (got.admission["gangs_placed"]
                     + got.admission["gangs_routed"])
    if gang_free and got.admission["tiers"] > 1:
        # the fused round: every loose tier in one dispatch
        assert got.admission["solve_dispatches"] == (
            1 if fused == "fused-on" else got.admission["tiers"])
    if name == "tier-fence":
        placed = {p.name for c in got.new_claims for p in c.pods}
        assert placed and all(n.startswith("hi") for n in placed)
        assert sum(1 for k in got.pod_errors if "/lo" in k) == 8


@pytest.mark.parametrize("seed", range(6))
def test_host_rung_equals_oracle_and_jax(seed):
    """The cascade's host rung (``HostSolver``) equals the port's
    tiered-FFD oracle, and both equal the JAX package's."""
    got = solve_round(PORT, gang_mix_small, seed, host=True)
    want = solve_round(JAX, gang_mix_small, seed, host=True)
    pods, catalog, _, _ = gang_mix_small(PORT, seed)
    templates, its, topo = _inputs(PORT, pods, catalog)
    oracle, rep = mod(PORT, "admission").tiered_ffd_oracle(
        [p.clone() for p in pods], templates, its, topology=topo)
    assert round_shape(got) == round_shape(oracle) == round_shape(want)
    assert rep["gangs_placed"] == got.admission["gangs_placed"]


# ---------------------------------------------------------------------------
# the tier split and the tiered solve
# ---------------------------------------------------------------------------

def _tiered(pkg, seed, n_pods=240, n_types=16):
    pods, pools, catalog = (
        mod(PORT, "workload").priority_mix(n_pods, n_types, seed)
        if pkg == PORT else
        importlib.import_module("perf.configs").priority_mix(
            n_pods, n_types, seed))
    ranks = {prio: i for i, prio in enumerate(sorted(
        {p.priority for p in pods}))}
    tier_of = {p.uid: ranks[p.priority] for p in pods}
    templates = sorted((mod(pkg, "models").ClaimTemplate(p) for p in pools),
                       key=lambda t: (-t.weight, t.nodepool_name))
    return pods, templates, {p.name: catalog for p in pools}, tier_of


SNAP_ARRAYS = ("g_tier", "g_demand", "g_count", "g_mask", "g_has", "g_tol",
               "g_tmpl_ok", "g_zone_allowed", "g_ct_allowed", "t_mask",
               "t_alloc", "m_mask")


@pytest.mark.parametrize("seed", [3, 7])
def test_tier_split_tensorize_matches_jax(seed):
    jp, jt, jits, jtier = _tiered(JAX, seed)
    tp, tt, tits, ttier = _tiered(PORT, seed)
    # uids differ between packages: the tiers are keyed per package
    assert sorted(jtier.values()) == sorted(ttier.values())
    js = mod(JAX, "ops.tensorize").tensorize(jp, jt, jits, tier_of=jtier)
    ts = mod(PORT, "ops.tensorize").tensorize(tp, tt, tits, tier_of=ttier)
    assert ts.n_tiers == js.n_tiers == 3
    assert [[p.name for p in g] for g in ts.groups] == [
        [p.name for p in g] for g in js.groups]
    assert ts.row_keys == js.row_keys
    # tier-major: the scan never returns to a higher tier
    assert (np.diff(ts.g_tier) <= 0).all()
    for name in SNAP_ARRAYS:
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name),
                                      err_msg=name)
    # the kernel sees the same rows, and packs them the same way
    from karpenter_tpu.ops import kernels as jkernels
    from karpenter_tpu_torch.ops import kernels as tkernels

    Gp, Tp = 256, 16
    jargs = mod(JAX, "ops.tensorize").kernel_args(js, Gp=Gp, Tp=Tp)
    targs = mod(PORT, "ops.tensorize").kernel_args(ts, Gp=Gp, Tp=Tp)
    assert set(jargs) == set(targs)
    for k in jargs:
        np.testing.assert_array_equal(np.asarray(targs[k]),
                                      np.asarray(jargs[k]), err_msg=k)
    want = jkernels.solve_step(dict(jargs), max_bins=128, use_pallas=False)
    got = tkernels.solve_step(tkernels.from_kernel_args(targs, "cpu"),
                              max_bins=128)
    for k in ("assign", "used", "tmpl", "tier"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["assign"].sum()) > 0


@pytest.mark.parametrize("seed", [3, 7])
def test_tiered_solve_matches_jax(seed):
    jp, jt, jits, jtier = _tiered(JAX, seed)
    tp, tt, tits, ttier = _tiered(PORT, seed)
    want = TPUSolver().solve(jp, jt, jits, tier_of=jtier)
    got = TorchSolver(device="cpu").solve(tp, tt, tits, tier_of=ttier)

    def claims(res):
        return [(tuple(sorted(p.name for p in c.pods)),
                 tuple(sorted(it.name for it in c.instance_types)),
                 getattr(c, "_tier", None)) for c in res.new_claims]

    assert claims(got) == claims(want)
    assert {c[2] for c in claims(got)} == {0, 1, 2}
    assert sorted(got.pod_errors) == sorted(want.pod_errors)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def _preempt_fleet(pkg, n_replicas=6, limits_cpu=None, victim_policy="",
                   victim_pdb=False, host=False):
    """``tests/test_fused_round.py``'s ``_preempt_fleet`` and
    ``tests/test_priority_admission.py``'s ``_preempt_env``."""
    ob = mod(pkg, "api.objects")
    catalog = [mod(pkg, "cloudprovider.catalog").make_instance_type(
        "xl", 16, 64)]
    env = mod(pkg, "operator").Environment(instance_types=catalog,
                                           solver=solver_of(pkg, host=host))
    env.create("nodepools", _pool(pkg, limits_cpu))
    env.create("priorityclasses",
               ob.PriorityClass(metadata=ob.ObjectMeta(name="high"),
                                value=10000),
               ob.PriorityClass(metadata=ob.ObjectMeta(name="low"), value=0,
                                preemption_policy=victim_policy))
    tpl = _pod(pkg, "low-tpl", cpu=5.0, mem=8.0, priority_class_name="low",
               labels={"app": "low"})
    env.store.create("deployments", ob.Deployment(
        metadata=ob.ObjectMeta(name="low"), replicas=n_replicas,
        template=tpl))
    if victim_pdb:
        env.store.create("pdbs", ob.PodDisruptionBudget(
            metadata=ob.ObjectMeta(name="low-pdb"),
            selector=ob.LabelSelector(match_labels={"app": "low"}),
            min_available=n_replicas))
    env.run_until_idle(max_rounds=300)
    return env


def _probe_inputs(pkg, env, n_pre=3):
    P = mod(pkg, "admission.preempt")
    store = env.store
    classes = {pc.name: pc for pc in store.list("priorityclasses")}
    prio_of = {p.uid: 0 for p in store.list("pods") if p.node_name}
    preemptors = []
    for i in range(n_pre):
        hi = _pod(pkg, f"hi{i}", cpu=6.0, mem=4.0,
                  priority_class_name="high")
        prio_of[hi.uid] = 10000
        preemptors.append(hi)
    topo = mod(pkg, "models.topology").Topology(domains={}, pods=preemptors)
    enodes = env.provisioner._existing_nodes(list(env.cluster.nodes()), topo)
    pdb = mod(pkg, "utils.pdb").PdbLimits(store)
    cand_lists = [P.victim_sets(hi, enodes, prio_of, classes, pdb, set())
                  for hi in preemptors]
    templates, its, _, _, _ = env.provisioner.solver_inputs()
    return P, preemptors, cand_lists, templates, its


def test_probe_feasible_batch_matches_per_preemptor_and_jax():
    got_env, want_env = _preempt_fleet(PORT), _preempt_fleet(JAX)
    P, pre, cands, tpl, its = _probe_inputs(PORT, got_env)
    JP, jpre, jcands, jtpl, jits = _probe_inputs(JAX, want_env)
    assert any(cands)
    # node names carry a process-wide counter: compare the bundles
    assert [[sorted(v.metadata.owner_references[0]["name"]
                    for v in c.victims) for c in cl] for cl in cands] == [
        [sorted(v.metadata.owner_references[0]["name"] for v in c.victims)
         for c in cl] for cl in jcands]
    batch = P.probe_feasible_batch(pre, cands, tpl, its, device="cpu")
    want = JP.probe_feasible_batch(jpre, jcands, jtpl, jits)
    assert batch is not None and batch == want
    assert any(any(b) for b in batch)
    for hi, cl, row in zip(pre, cands, batch):
        assert P.probe_feasible(hi, cl, tpl, its, device="cpu") == row
    # nothing to probe, nothing dispatched
    assert P.probe_feasible_batch([], [], None, None, device="cpu") == []
    assert P.probe_feasible_batch([pre[0]], [[]], None, None,
                                  device="cpu") == [[]]


def test_probes_default_to_cuda(monkeypatch):
    """With no device named the probes run on CUDA, and raise without a
    card instead of dropping to the CPU, as ``TorchSolver()`` does."""
    import torch

    P = mod(PORT, "admission.preempt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.probe_feasible(None, [], None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.probe_feasible_batch([], [], None, None)


def _evicted_names(env):
    import re

    return sorted(re.sub(r"-[0-9a-z]+$", "", p.metadata.name)
                  for p in env.store.list("pods")
                  if p.metadata.deletion_timestamp is not None)


def _preempt_run(pkg, n_nodes):
    """``perf/run.py``'s preempt-mix through one package's
    ``Environment``: the high tier injected into ``preempt_env``."""
    if pkg == PORT:
        env = mod(PORT, "workload").preempt_env(n_nodes,
                                                solver=solver_of(PORT))
    else:
        env = importlib.import_module("perf.configs").preempt_env(n_nodes)
    m = mod(pkg, "operator.metrics")
    evicted = []
    real = env.store.evict

    def evict(p):
        evicted.append(p.metadata.owner_references[0]["name"])
        return real(p)

    env.store.evict = evict
    for i in range(n_nodes):
        env.store.create("pods", _pod(pkg, f"hi{i}", 6.0, 4.0,
                                      priority_class_name="high"))
    env.run_until_idle(max_rounds=500)
    ctr = env.registry.counter(m.ADMISSION_PREEMPTIONS)
    return dict(
        hi_bound=sorted(p.metadata.name for p in env.store.list("pods")
                        if p.node_name and p.metadata.name.startswith("hi")),
        confirmed=int(ctr.value(outcome="confirmed")),
        declined=int(ctr.value(outcome="declined")),
        evictions=int(env.registry.counter(m.ADMISSION_EVICTIONS).total()),
        evicted=sorted(evicted),
        nodes=len(env.store.list("nodes")))


def test_preempt_env_matches_jax():
    got, want = _preempt_run(PORT, 4), _preempt_run(JAX, 4)
    assert got == want
    assert len(got["hi_bound"]) == 4 and got["confirmed"] == 4
    assert got["evictions"] == 8 and got["declined"] == 0


def _cheapest_infeasible_fleet(pkg, host=False):
    """Two full nodes under a 32-cpu limit: the cheapest candidate (one
    1-cpu low victim beside a 13-cpu high pod) cannot free room for a
    6-cpu preemptor, the dearer one (three 4.5-cpu low victims) can. With
    one confirm per preemptor only the probe finds the second node."""
    ob = mod(pkg, "api.objects")
    catalog = [mod(pkg, "cloudprovider.catalog").make_instance_type(
        "xl", 16, 64)]
    env = mod(pkg, "operator").Environment(instance_types=catalog,
                                           solver=solver_of(pkg, host=host))
    env.create("nodepools", _pool(pkg, "32"))
    env.create("priorityclasses",
               ob.PriorityClass(metadata=ob.ObjectMeta(name="high"),
                                value=10000),
               ob.PriorityClass(metadata=ob.ObjectMeta(name="low"), value=0))

    def deployment(name, replicas, cpu, pc):
        tpl = _pod(pkg, f"{name}-tpl", cpu=cpu, mem=2.0,
                   priority_class_name=pc, labels={"app": name})
        env.store.create("deployments", ob.Deployment(
            metadata=ob.ObjectMeta(name=name), replicas=replicas,
            template=tpl))

    deployment("keep", 1, 13.0, "high")
    deployment("small", 1, 1.0, "low")
    env.run_until_idle(max_rounds=300)
    deployment("wide", 3, 4.5, "low")
    env.run_until_idle(max_rounds=300)
    return env


PREEMPT_CASES = {
    "confirmed": dict(limits_cpu="16", n_replicas=3),
    "confirmed-host-solver": dict(limits_cpu="16", n_replicas=3, host=True),
    "never-victims": dict(limits_cpu="16", n_replicas=3,
                          victim_policy="Never"),
    "pdb-blocked": dict(limits_cpu="16", n_replicas=3, victim_pdb=True),
    "never-preemptor": dict(limits_cpu="16", n_replicas=3),
    "cheapest-infeasible": dict(fleet=_cheapest_infeasible_fleet),
    "cheapest-infeasible-host-solver": dict(
        fleet=_cheapest_infeasible_fleet, host=True),
}


@pytest.mark.parametrize("case", sorted(PREEMPT_CASES))
def test_preemption_ladder_matches_jax(case, monkeypatch):
    """The ladder's outcome, with a ``TorchSolver`` round and with a
    ``HostSolver`` round: either probes (the host round on the CPU plain
    path) and confirms only what the probe marks feasible."""
    fleet_kw = dict(PREEMPT_CASES[case])
    fleet = fleet_kw.pop("fleet", _preempt_fleet)
    if fleet is _cheapest_infeasible_fleet:
        monkeypatch.setenv("KARPENTER_PREEMPT_CONFIRMS", "1")

    def run(pkg):
        env = fleet(pkg, **fleet_kw)
        m = mod(pkg, "operator.metrics")
        kw = ({"preemption_policy": "Never"}
              if case == "never-preemptor" else {})
        env.store.create("pods", _pod(pkg, "hi", cpu=6.0, mem=4.0,
                                      priority_class_name="high", **kw))
        env.run_until_idle(max_rounds=400)
        hi = env.store.try_get("pods", "hi")
        ctr = env.registry.counter(m.ADMISSION_PREEMPTIONS)
        return (bool(hi.node_name), int(ctr.value(outcome="confirmed")),
                int(env.registry.counter(m.ADMISSION_EVICTIONS).total()),
                _evicted_names(env))

    got, want = run(PORT), run(JAX)
    assert got == want
    assert got[0] == (case.startswith("confirmed")
                      or case.startswith("cheapest-infeasible"))


# ---------------------------------------------------------------------------
# the provisioner and the fault rule
# ---------------------------------------------------------------------------

def _marked_env(pkg):
    ob = mod(pkg, "api.objects")
    catalog = [mod(pkg, "cloudprovider.catalog").make_instance_type(
        "m", 8, 32)]
    env = mod(pkg, "operator").Environment(instance_types=catalog,
                                           solver=solver_of(pkg))
    env.create("nodepools", _pool(pkg, "16"))
    env.create("priorityclasses", ob.PriorityClass(
        metadata=ob.ObjectMeta(name="batch"), value=100,
        global_default=True))
    pods = []
    for i in range(10):
        p = _pod(pkg, f"u{i}", cpu=3.0, mem=1.0)
        if i % 3 == 0:
            p.priority = 5000
        pods.append(p)
    env.provision(*pods)
    return env


def test_provisioner_routes_marked_batches_through_the_plane():
    """A batch with pod priorities and a tiering default class solves
    through the admission plane (the high tier owns the capped pool), as
    in the JAX package."""
    def state(env):
        return sorted((p.metadata.name, bool(p.node_name))
                      for p in env.store.list("pods"))

    got_env, want_env = _marked_env(PORT), _marked_env(JAX)
    assert got_env.provisioner._admission is not None
    assert state(got_env) == state(want_env)
    bound = {n for n, b in state(got_env) if b}
    assert {"u0", "u3", "u6", "u9"} <= bound and len(bound) < 10


def test_gang_trial_fault_rule(monkeypatch):
    """A host-side error in a gang trial routes the gang (``trial-error``)
    as in the JAX package; a kernel fault propagates."""
    from karpenter_tpu_torch.ops.cuda_kernels import KernelError

    pods, catalog, _, _ = quorum_gang(PORT, 0)
    wk = mod(PORT, "api.labels")
    for p in pods:
        p.metadata.annotations.pop(wk.POD_GROUP_MIN_ANNOTATION)
    templates, its, topo = _inputs(PORT, pods, catalog)
    solver = TorchSolver(device="cpu")
    plane = mod(PORT, "admission").AdmissionPlane()

    def raising(exc):
        def solve(*a, **kw):
            raise exc
        return solve

    monkeypatch.setattr(solver, "solve", raising(NotImplementedError("x")))
    res = plane.solve_round(solver, pods, templates, its, topology=topo)
    assert res.admission["gangs_routed"] == 1
    assert len(res.pod_errors) == 3
    assert all("trial solve raised" in e for e in res.pod_errors.values())
    monkeypatch.setattr(solver, "solve", raising(KernelError("launch")))
    with pytest.raises(KernelError):
        plane.solve_round(solver, pods, templates, its, topology=topo)
