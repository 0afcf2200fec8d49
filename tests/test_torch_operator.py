"""The port's operator loop against the JAX package's: provisioning.

Each scenario is written once and built twice, each time with one
package's own objects and driven through that package's ``Environment``:
the JAX package with ``TPUSolver`` on the CPU (as its tests pin it,
``KARPENTER_NATIVE_CUTOFF=0``), the port with ``TorchSolver(device="cpu")``.

- **The provisioning loop** (the shapes of ``tests/test_e2e_provisioning.py``:
  single pod, batch packing, new pods after quiesce, daemonset overhead,
  taints/tolerations, zonal spread, limits, insufficient capacity, the
  nominated node): both packages end with the same nodes (instance type,
  pool, capacity type, zone and the pods on each, by owner — never by
  generated name), the same unbound pods and the same FailedScheduling
  messages. Tolerance: exact.
- **``existing_base=``**: on the config-4 fleet built through the loop, a
  confirming simulation through the round's snapshot
  (``simulate_scheduling(bundle=...)``, which solves with
  ``existing_base=bundle``) gives exactly what the fresh
  ``existing_nodes`` path gives, in each package, and the port's equals
  the JAX package's.
- **Admission markers**: a live batch with a pod priority solves
  through the port's admission plane, as the JAX package's does, and a
  marker-free batch keeps the plain solve.

The harness here (``Kit``, ``CommandLog``, ``end_state``, ``converge``,
the fleets) is shared with ``tests/test_torch_disruption.py``.
"""

from __future__ import annotations

import importlib
import random
import re

import pytest

from karpenter_tpu.models.solver import TPUSolver
from karpenter_tpu_torch.models.solver import TorchSolver

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"
GIB = 2**30


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class Kit:
    """One package's objects under the names the scenarios use."""

    def __init__(self, pkg):
        self.pkg = pkg
        ob = mod(pkg, "api.objects")
        for name in ("ObjectMeta", "Pod", "DaemonSet", "Deployment", "Taint",
                     "Toleration", "TopologySpreadConstraint",
                     "LabelSelector", "NodeSelectorRequirement",
                     "PodDisruptionBudget"):
            setattr(self, name, getattr(ob, name))
        np_mod = mod(pkg, "api.nodepool")
        self.NodePool, self.Budget = np_mod.NodePool, np_mod.Budget
        self.WHEN_EMPTY = np_mod.CONSOLIDATION_WHEN_EMPTY
        self.wk = mod(pkg, "api.labels")
        self.make_instance_type = mod(
            pkg, "cloudprovider.catalog").make_instance_type
        self.Environment = mod(pkg, "operator").Environment
        self.Options = mod(pkg, "operator.options").Options

    def solver(self):
        return TPUSolver() if self.pkg == JAX else TorchSolver(device="cpu")

    def env(self, types, **kw):
        return self.Environment(
            instance_types=[self.make_instance_type(*t) for t in types],
            solver=self.solver(), **kw)

    def nodepool(self, name="default", **kw):
        np_ = self.NodePool(metadata=self.ObjectMeta(name=name))
        for k, v in kw.items():
            setattr(np_.spec.template, k, v)
        return np_

    def pod(self, name, cpu=1.0, mem_gib=1.0, **kw):
        return self.Pod(
            metadata=self.ObjectMeta(name=name, labels=kw.pop("labels", {})),
            requests={"cpu": cpu, "memory": mem_gib * GIB}, **kw)

    def deployment(self, name, replicas, cpu, mem_gib, labels=None):
        return self.Deployment(
            metadata=self.ObjectMeta(name=name), replicas=replicas,
            template=self.pod(f"{name}-tpl", cpu, mem_gib,
                              labels=dict(labels or {})))


def owner(pod) -> str:
    """A pod by its owning deployment (workload pods' names carry a
    process-wide counter), else by its own name."""
    refs = pod.metadata.owner_references
    return refs[0]["name"] if refs else pod.metadata.name


def fleet_cost(env) -> float:
    view = mod(type(env).__module__.split(".")[0],
               "cloudprovider.types").CatalogView(
        env.store.list("nodepools"), env.cloud)
    total = 0.0
    for n in env.store.list("nodes"):
        off = view.offering(n.labels)
        total += off.price if off is not None else 0.0
    return total


def end_state(env) -> tuple:
    """``(nodes, unbound pods, cost)``: every live node as (instance type,
    pool, capacity type, zone, its pods by owner), sorted; the unbound
    pods by owner; the fleet's hourly price."""
    wk = mod(type(env).__module__.split(".")[0], "api.labels")
    pods_on: dict = {}
    unbound = []
    for p in env.store.list("pods"):
        if p.metadata.deletion_timestamp is not None:
            continue
        if p.node_name:
            pods_on.setdefault(p.node_name, []).append(owner(p))
        else:
            unbound.append(owner(p))
    nodes = sorted(
        (n.labels.get(wk.INSTANCE_TYPE_LABEL, ""),
         n.labels.get(wk.NODEPOOL_LABEL, ""),
         n.labels.get(wk.CAPACITY_TYPE_LABEL, ""),
         n.labels.get(wk.TOPOLOGY_ZONE_LABEL, ""),
         tuple(sorted(pods_on.get(n.name, ()))))
        for n in env.store.list("nodes")
        if n.metadata.deletion_timestamp is None)
    return nodes, sorted(unbound), round(fleet_cost(env), 9)


def failed_scheduling(env) -> list:
    """FailedScheduling messages with generated names and uids masked."""
    return sorted(
        re.sub(r"\d+", "#", e.message)
        for e in env.recorder.by_reason("FailedScheduling"))


class CommandLog:
    """Every command the disruption controller executes, in order: the
    method, its rung (``GlobalConsolidation``'s verdict and the ladder
    probes' kind), the action, the candidates by creation order and the
    replacements' instance types."""

    def __init__(self, env):
        self.env = env
        self.commands = []
        self._ordinal: dict = {}
        self._seq = 0
        d = env.disruption
        real = d._execute

        def execute(cmd, method=None):
            self.commands.append(self.describe(cmd, method))
            return real(cmd, method)

        d._execute = execute
        # the global method's verdict reason, as each package hands it
        # to its decision ledger
        for method in d.methods:
            if hasattr(method, "_verdict"):
                method._verdict = self._verdict_spy(method)

    @staticmethod
    def _verdict_spy(method):
        real = method._verdict

        def verdict(rung, reason="ok"):
            method.logged_reason = reason
            return real(rung, reason)

        return verdict

    def ordinal(self, name):
        """A node's place in creation order: its claim's uid counter,
        ranked over every claim seen in this environment."""
        if name not in self._ordinal:
            fresh = [nc.name for nc in self.env.store.list("nodeclaims")
                     if nc.name not in self._ordinal]
            for nm in sorted(fresh, key=lambda s: [
                    int(x) for x in re.findall(r"\d+", s)]):
                self._ordinal[nm] = self._seq
                self._seq += 1
        return self._ordinal.get(name, -1)

    def describe(self, cmd, method) -> tuple:
        rung = ""
        if method is not None:
            rung = getattr(method, "last_probe", "")
            if getattr(method, "last_rung", ""):
                rung = f"{method.last_rung}/{method.logged_reason}"
        return (
            type(method).__name__ if method is not None else "",
            rung,
            cmd.action,
            tuple(self.ordinal(c.name) for c in cmd.candidates),
            tuple(tuple(sorted(it.name for it in claim.instance_types))
                  for claim in cmd.replacements),
        )


def converge(env, max_rounds=60, idle_rounds=400) -> int:
    """``perf/run.py``'s ``_converge_disruption``: step the clock past
    the validation TTL and poll period, run to idle, until the node count
    holds for three rounds. Returns the rounds."""
    env.disruption.poll_period = 0.0
    rounds = stable = 0
    while rounds < max_rounds and stable < 3:
        before = len(env.store.list("nodes"))
        env.clock.step(20.0)
        env.run_until_idle(max_rounds=idle_rounds)
        rounds += 1
        stable = stable + 1 if len(env.store.list("nodes")) == before else 0
    return rounds


def _fleet_env(pkg, deploys):
    """``perf/configs.py``'s config-4 environment with the given
    ``(cpu, replicas, kept)`` deployments: provisioned, bound, scaled
    down; disruption armed."""
    k = Kit(pkg)
    env = k.Environment(
        instance_types=[k.make_instance_type("xl", 16, 64)],
        solver=k.solver(), enable_disruption=True,
        options=k.Options.from_env(
            feature_gates={"spot_to_spot_consolidation": True}))
    env.disruption.poll_period = float("inf")
    pool = k.nodepool()
    pool.spec.disruption.consolidate_after = 0.0
    pool.spec.disruption.budgets[0].nodes = "100%"
    env.create("nodepools", pool)
    ds = [k.deployment(f"d{i}", replicas, cpu, 2 * cpu)
          for i, (cpu, replicas, _) in enumerate(deploys)]
    for d in ds:
        env.store.create("deployments", d)
    env.run_until_idle(max_rounds=400)
    for d, (_, _, kept) in zip(ds, deploys):
        d.replicas = kept
        env.store.update("deployments", d)
    env.run_until_idle(max_rounds=400)
    return env


def config4_env(pkg, n_nodes):
    """``config4_consolidation_env(n_nodes)``: n deployments of three
    5-cpu/10-GiB replicas, scaled to one."""
    if pkg == PORT:
        from karpenter_tpu_torch.workload import consolidation_env

        env = consolidation_env(n_nodes, solver=TorchSolver(device="cpu"))
        env.disruption.poll_period = float("inf")
        return env
    from perf import configs

    env = configs.config4_consolidation_env(n_nodes)
    env.provisioner.solver = TPUSolver()
    env.disruption.poll_period = float("inf")
    return env


def mixed_env(pkg, n_deploys, seed):
    """``tests/test_global_consolidation.py``'s seeded mixed fleet: the
    config-4 shape with pods of 2.5, 5 or 7.5 cpu (several groups)."""
    r = random.Random(seed)
    return _fleet_env(pkg, [(r.choice((2.5, 5.0, 7.5)), 3, 1)
                            for _ in range(n_deploys)])


# ---------------------------------------------------------------------------
# the provisioning loop: the shapes of tests/test_e2e_provisioning.py
# ---------------------------------------------------------------------------

E2E_TYPES = [("small", 2, 8), ("medium", 8, 32), ("large", 32, 128)]


def _single_pod(k, env):
    env.create("nodepools", k.nodepool())
    env.provision(k.pod("p1"))


def _no_nodepool(k, env):
    env.provision(k.pod("p1"))


def _batch_packs(k, env):
    env.create("nodepools", k.nodepool())
    env.provision(*[k.pod(f"p{i}", cpu=0.5, mem_gib=0.5) for i in range(20)])


def _new_pods_after_quiesce(k, env):
    env.create("nodepools", k.nodepool())
    env.provision(k.pod("p1"))
    env.provision(k.pod("p2", cpu=30))


def _daemonset_overhead(k, env):
    env.create("nodepools", k.nodepool())
    ds_pod = k.Pod(metadata=k.ObjectMeta(name="ds-template"),
                   requests={"cpu": 1.5, "memory": 1 * GIB})
    env.create("daemonsets", k.DaemonSet(
        metadata=k.ObjectMeta(name="logging"), template=ds_pod))
    env.provision(k.pod("p1", cpu=1.0))


def _taints(k, env):
    env.create("nodepools", k.nodepool(name="tainted", taints=[
        k.Taint(key="dedicated", value="infra", effect="NoSchedule")]))
    env.provision(k.pod("plain"), k.pod("tolerant", tolerations=[
        k.Toleration(key="dedicated", value="infra")]))


def _zonal_spread(k, env):
    env.create("nodepools", k.nodepool())
    tsc = k.TopologySpreadConstraint(
        max_skew=1, topology_key=k.wk.TOPOLOGY_ZONE_LABEL,
        when_unsatisfiable="DoNotSchedule",
        label_selector=k.LabelSelector(match_labels={"app": "web"}))
    env.provision(*[k.pod(f"p{i}", cpu=3.0, labels={"app": "web"},
                          topology_spread_constraints=[tsc])
                    for i in range(6)])


def _limits(k, env):
    np_ = k.nodepool()
    np_.spec.limits = {"cpu": 34.0}
    env.create("nodepools", np_)
    env.provision(*[k.pod(f"p{i}", cpu=20) for i in range(4)])


def _insufficient_capacity(k, env):
    env.create("nodepools", k.nodepool())
    env.provision(k.pod("huge", cpu=1000))


def _nominated_node(k, env):
    env.create("nodepools", k.nodepool())
    env.provision(k.pod("p1"))
    env.provision(*[k.pod(f"q{i}", cpu=0.25, mem_gib=0.25) for i in range(3)])


PROVISIONING = {
    "single-pod": _single_pod,
    "no-nodepool": _no_nodepool,
    "batch-packs": _batch_packs,
    "new-pods-after-quiesce": _new_pods_after_quiesce,
    "daemonset-overhead": _daemonset_overhead,
    "taints-tolerations": _taints,
    "zonal-spread": _zonal_spread,
    "limits": _limits,
    "insufficient-capacity": _insufficient_capacity,
    "nominated-node": _nominated_node,
}


def _provisioned(pkg, scenario):
    k = Kit(pkg)
    env = k.env(E2E_TYPES)
    PROVISIONING[scenario](k, env)
    claims = sorted(
        (nc.metadata.labels.get(k.wk.INSTANCE_TYPE_LABEL, ""),
         nc.metadata.labels.get(k.wk.NODEPOOL_LABEL, ""))
        for nc in env.store.list("nodeclaims"))
    nominated = sorted(owner(p) for p in env.store.list("pods")
                       if p.nominated_node_name
                       and p.nominated_node_name == p.node_name)
    return (end_state(env), claims, nominated, failed_scheduling(env),
            env.provisioner.solver)


@pytest.mark.parametrize("scenario", sorted(PROVISIONING))
def test_provisioning_loop_matches_jax(scenario):
    want = _provisioned(JAX, scenario)
    got = _provisioned(PORT, scenario)
    assert got[:4] == want[:4]
    # the port's device path ran wherever the JAX package's did
    def on_host(solver):
        return solver.last_device_stats.get("engine") == "host"

    assert on_host(got[4]) == on_host(want[4])


def test_provisioning_scenarios_land():
    """The scenarios' own expectations, on the port: the assertions of
    ``tests/test_e2e_provisioning.py`` for the shapes above."""
    def nodes(scenario):
        (nodes_, unbound, _), claims, nominated, errors, _ = _provisioned(
            PORT, scenario)
        return nodes_, unbound, claims, nominated, errors

    n, unbound, _, _, _ = nodes("single-pod")
    assert len(n) == 1 and n[0][1] == "default" and n[0][4] == ("p1",)
    assert not unbound
    n, unbound, _, _, _ = nodes("no-nodepool")
    assert n == [] and unbound == ["p1"]
    n, _, _, _, _ = nodes("batch-packs")
    assert len(n) == 1 and len(n[0][4]) == 20
    assert len(nodes("new-pods-after-quiesce")[0]) == 2
    n, _, _, _, _ = nodes("daemonset-overhead")
    assert n[0][0] != "small"
    n, unbound, _, _, _ = nodes("taints-tolerations")
    assert unbound == ["plain"] and n[0][4] == ("tolerant",)
    n, unbound, _, _, _ = nodes("zonal-spread")
    zones: dict = {}
    for node in n:
        zones[node[3]] = zones.get(node[3], 0) + len(node[4])
    assert not unbound and max(zones.values()) - min(zones.values()) <= 1
    n, unbound, _, _, _ = nodes("limits")
    assert len(n) == 1 and len(unbound) == 3
    n, unbound, claims, _, errors = nodes("insufficient-capacity")
    assert n == [] and claims == [] and unbound == ["huge"] and errors
    _, unbound, _, nominated, _ = nodes("nominated-node")
    assert not unbound and "p1" in nominated


# ---------------------------------------------------------------------------
# TorchSolver.solve(existing_base=...): the confirming simulation's snapshot
# ---------------------------------------------------------------------------


def _sim_claims(sim) -> tuple:
    new = sorted(
        (tuple(sorted(it.name for it in c.instance_types)),
         c.template.nodepool_name, tuple(sorted(owner(p) for p in c.pods)))
        for c in sim.new_claims)
    placed = sorted(
        (n.state_node.provider_id, tuple(sorted(
            owner(p) for p in getattr(n, "scheduled_pods", None) or ())))
        for n in sim.results.existing_nodes
        if getattr(n, "scheduled_pods", None))
    return new, len(placed), sum(len(p[1]) for p in placed), \
        sorted(sim.results.pod_errors)


def _simulations(pkg, n_nodes=12):
    env = config4_env(pkg, n_nodes)
    cons = mod(pkg, "ops.consolidate")
    helpers = mod(pkg, "controllers.disruption.helpers")
    d = env.disruption
    cands = sorted(helpers.get_candidates(d.cluster, d.store, d.cloud,
                                          d.clock),
                   key=lambda c: c.disruption_cost)
    cache = cons.SnapshotCache()
    bundle = cache.get(env.provisioner, env.cluster, env.store, cands)
    assert bundle is not None
    out = []
    for sel in (cands[:1], cands[:4], cands[: 2 * n_nodes // 3],
                cands[: 2 * n_nodes // 3 + 1]):
        fast = helpers.simulate_scheduling(
            env.provisioner, env.cluster, env.store, sel,
            inputs=cache.inputs_for(env.cluster), bundle=bundle)
        slow = helpers.simulate_scheduling(
            env.provisioner, env.cluster, env.store, sel)
        out.append((_sim_claims(fast), _sim_claims(slow),
                     fast.all_pods_scheduled(), slow.all_pods_scheduled()))
    return out


def test_existing_base_equals_the_fresh_existing_nodes_path(monkeypatch):
    """The bundle's sliced existing-node tensors give the solve the fresh
    ``tensorize_existing`` gives — in the port and the JAX package — and
    the port's simulations equal the JAX package's."""
    derived = []
    real = mod(PORT, "ops.consolidate").DisruptionSnapshot.derive_esnap

    def spy(self, sim_snap, existing_nodes):
        out = real(self, sim_snap, existing_nodes)
        derived.append(out is not None)
        return out

    monkeypatch.setattr(mod(PORT, "ops.consolidate").DisruptionSnapshot,
                        "derive_esnap", spy)
    got = _simulations(PORT)
    want = _simulations(JAX)
    assert derived and all(derived), "the port never sliced the bundle"
    for fast, slow, fast_ok, slow_ok in got:
        assert fast == slow and fast_ok == slow_ok
    for fast, slow, _, _ in want:
        assert fast == slow
    assert got == want


# ---------------------------------------------------------------------------
# admission markers: the admission plane
# ---------------------------------------------------------------------------


def test_admission_markers_raise_not_solve():
    """A marked batch no longer raises: it solves through the admission
    plane and lands where the JAX package's does. A marker-free batch
    does not engage the plane and takes the plain solve."""
    def marked(pkg):
        k = Kit(pkg)
        env = k.env(E2E_TYPES)
        env.create("nodepools", k.nodepool())
        p = k.pod("urgent")
        p.priority = 1000
        env.provision(p)
        return env

    got, want = marked(PORT), marked(JAX)
    assert got.provisioner._admission is not None
    assert end_state(got) == end_state(want)
    assert got.store.try_get("pods", "urgent").node_name
    k = Kit(PORT)
    env2 = k.env(E2E_TYPES)
    env2.create("nodepools", k.nodepool())
    (q,) = env2.provision(k.pod("plain"))
    assert q.node_name
    assert not env2.provisioner.admission_plane().engages([q])
