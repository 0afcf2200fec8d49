"""The consolidation kind's system under test: one disruption decision of
``karpenter_tpu_torch`` over an underutilized fleet.

The only module of this kind that imports the program. It builds each
plain fleet of ``portbench/fleet.py`` as the program's objects, as the
port's own ``workload.underutilized_fleet`` builds its fleet: a
``KubeStore`` holding the configuration's NodePools (with their
disruption settings), one launched, registered and initialized NodeClaim
and its Node per node (kwok's ``create`` with the claim pinned to the
fleet's instance type and offering, and the labels its type gives a
node), and the bound pods, each owned by
its Deployment; a ``Cluster`` fed the store's events; and a
``Provisioner`` over the one ``TorchSolver`` of the run.

A decision (``Program.decide``) is the first ``_compute_round`` of a
``DisruptionController`` built for it before the clock starts, under the
``disrupt`` round trace, as ``poll`` opens it: cold (no snapshot, no
pending command, no noop fence), with the kernels and the catalog warm.
It ends at the command the round leaves pending (validation is a later
round), with the card synchronised. Nothing is executed: a command the
ladder would execute at once is held as it is, so the fleet stands
unchanged for the next decision, and ``Fleet.reset`` hands it back as it
was made.

The answer is read from the decision's own result, never solved again:
the command's retired nodes and replacement claims, and the confirming
simulation that produced it (``simulate_scheduling``'s
``SchedulerResults``), which says where each displaced pod went.
"""

from __future__ import annotations

import contextlib

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.nodeclaim import (
    COND_INITIALIZED,
    COND_LAUNCHED,
    COND_REGISTERED,
    NodeClaim,
    NodeClaimSpec,
)
from karpenter_tpu_torch.api.nodepool import Budget, NodePool
from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, ObjectMeta, Pod
from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
from karpenter_tpu_torch.controllers.disruption import methods
from karpenter_tpu_torch.controllers.disruption.controller import DisruptionController
from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner
from karpenter_tpu_torch.kube.store import KubeStore
from karpenter_tpu_torch.models.solver import TorchSolver
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.utils.clock import FakeClock

from portbench import system


def nodepools(cfg: dict) -> list:
    """The configuration's NodePools with their disruption settings."""
    out = []
    for p in cfg["nodepools"]:
        pool = NodePool(metadata=ObjectMeta(name=p["name"]))
        pool.spec.weight = p["weight"]
        d = p["disruption"]
        pool.spec.disruption.consolidation_policy = d["consolidation_policy"]
        pool.spec.disruption.consolidate_after = d["consolidate_after"]
        pool.spec.disruption.budgets = [Budget(nodes=d["budget"])]
        out.append(pool)
    return out


class Fleet:
    """One plain fleet as the program's objects, and the state a decision
    may memoise on them as it was made: ``reset`` restores every pod,
    node and NodeClaim of the store and every StateNode of the cluster to
    it."""

    def __init__(self, plain: dict, cfg: dict, its: list, solver, options: dict):
        self.plain = plain
        self.options = options
        type_labels = {it.name: {k: next(iter(r.values)) for k, r in it.requirements.items()
                                 if not r.complement and len(r.values) == 1}
                       for it in its}
        clock = FakeClock()
        store = KubeStore(clock=clock)
        cloud = KwokCloudProvider(store, its)
        by_name = {it.name: it for it in its}
        # kwok's create scans its catalog for the cheapest compatible
        # offering; the claim pins one, so a provider holding the pinned
        # type alone makes the same node without the scan
        launch = {}
        for pool in nodepools(cfg):
            store.create("nodepools", pool)
        by_node: dict = {}
        for p in plain["pods"]:
            by_node.setdefault(p["node"], []).append(p)
        for n in plain["nodes"]:
            pods = by_node.get(n["name"], [])
            pin = {wk.NODEPOOL_LABEL: n["pool"], wk.INSTANCE_TYPE_LABEL: n["type"],
                   wk.CAPACITY_TYPE_LABEL: n["capacity_type"],
                   wk.TOPOLOGY_ZONE_LABEL: n["zone"]}
            # the claim was sized for the replicas the node held before
            # the scale-down (fleet.py)
            sized = n["sized_for"]
            if n["type"] not in launch:
                launch[n["type"]] = KwokCloudProvider(store, [by_name[n["type"]]])
            claim = launch[n["type"]].create(NodeClaim(
                metadata=ObjectMeta(name=n["name"], namespace="",
                                    labels={wk.NODEPOOL_LABEL: n["pool"]}),
                spec=NodeClaimSpec(
                    requirements=[NodeSelectorRequirement(key=key, operator="In",
                                                          values=[v])
                                  for key, v in pin.items()],
                    resource_requests={"cpu": sized["cpu"],
                                       "memory": float(sized["mem"]),
                                       "pods": float(sized["pods"])})))
            for cond in (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED):
                claim.set_condition(cond)
            # the labels a node of the type carries (kubelet's arch and os,
            # the cloud provider's type labels), which kwok leaves out
            claim.metadata.labels.update(type_labels[n["type"]])
            store.create("nodeclaims", claim)
            # registration and initialization, as the lifecycle controller
            # leaves a node: startup taints gone, the two labels set
            node = store.get("nodes", n["name"])
            node.metadata.labels.update(type_labels[n["type"]])
            node.taints = []
            node.metadata.labels[wk.NODE_REGISTERED_LABEL] = "true"
            node.metadata.labels[wk.NODE_INITIALIZED_LABEL] = "true"
            store.update("nodes", node)
            for p in pods:
                store.create("pods", Pod(
                    metadata=ObjectMeta(
                        name=p["name"], namespace="default",
                        owner_references=[{"kind": "Deployment",
                                           "name": p["deployment"],
                                           "controller": True}]),
                    requests={"cpu": p["cpu"], "memory": float(p["mem"])},
                    node_selector=dict(p["selector"]),
                    node_name=n["name"], phase="Running"))
        for provider in launch.values():
            cloud.created.update(provider.created)
        cluster = Cluster(store, clock=clock)
        for event in store.drain_events():
            cluster.on_event(event)
        self.store, self.cloud, self.cluster, self.clock = store, cloud, cluster, clock
        self.provisioner = Provisioner(store, cloud, solver=solver, clock=clock,
                                       cluster=cluster)
        self.pods = store.list("pods")
        self._objects = (self.pods + store.list("nodes") + store.list("nodeclaims")
                         + list(cluster.state_nodes()) + [cluster])
        self._made = [dict(o.__dict__) for o in self._objects]
        self.reset()

    def reset(self) -> None:
        """The fleet as it was made, and a fresh disruption controller for
        the next decision: cold, its first round still to run."""
        for obj, made in zip(self._objects, self._made):
            d = obj.__dict__
            d.clear()
            d.update(made)
        self.controller = DisruptionController(
            self.store, self.cluster, self.cloud, self.provisioner,
            clock=self.clock, options=self.options, poll_period=0.0,
            validation_ttl=0.0)
        # the decision ends at its command: one the ladder would execute
        # at once is held, not executed
        self.held = []
        self.controller._execute = lambda cmd, method=None: self.held.append(cmd) or True


class Decision:
    """What one decision left: its command (None for none) and the
    confirming simulations of the round, in order."""

    def __init__(self, command, sims):
        self.command = command
        self.sims = sims


class Program:
    """The program set up for one configuration: its instance types, the
    disruption options its NodePools state and one ``TorchSolver`` on
    ``device``."""

    def __init__(self, cfg: dict, plain_catalog: list, traffic: dict, device=None):
        self.cfg = cfg
        self.its = system.instance_types(cfg, plain_catalog)
        self.options = dict(cfg["feature_gates"])
        self.solver = TorchSolver(device=device)
        self.cuda = self.solver.device.type == "cuda"

    def batch(self, plain: dict) -> Fleet:
        return Fleet(plain, self.cfg, self.its, self.solver, self.options)

    def decide(self, fleet: Fleet):
        """One disruption decision over ``fleet`` by its fresh controller;
        returns the ``Decision`` and the round's trace (None with the
        tracer off)."""
        import torch

        controller = fleet.controller
        sims: list = []
        with _record_simulations(sims), obs.round_trace("disrupt") as trace:
            controller._compute_round()
            if self.cuda:
                torch.cuda.synchronize()
        pending = controller._pending[0] if controller._pending is not None else None
        command = pending if pending is not None else (fleet.held[0] if fleet.held else None)
        return Decision(command, sims), (trace if isinstance(trace, obs.Trace) else None)

    @staticmethod
    def answer(decision: Decision) -> dict:
        return answer(decision)

    @staticmethod
    def tally(decision: Decision) -> tuple:
        """(displaced pods the command places, 0): a shipped command has
        a home for every pod it displaces."""
        cmd = decision.command
        return (sum(len(c.reschedulable_pods) for c in cmd.candidates)
                if cmd is not None else 0), 0

    @property
    def engine(self) -> str | None:
        """The engine of the last solve (``last_device_stats``)."""
        return self.solver.last_device_stats.get("engine")

    compat_launches = staticmethod(system.compat_launches)
    record_compat = staticmethod(system.record_compat)


@contextlib.contextmanager
def _record_simulations(sims: list):
    """Within the block, append ``(candidate provider ids, SimulationResults)``
    of every simulation the disruption methods run (``methods.py`` calls
    ``simulate_scheduling`` by that module's name)."""
    simulate = methods.simulate_scheduling

    def recorded(provisioner, cluster, store, candidates, **kw):
        out = simulate(provisioner, cluster, store, candidates, **kw)
        sims.append((frozenset(c.provider_id for c in candidates), out))
        return out

    methods.simulate_scheduling = recorded
    try:
        yield
    finally:
        methods.simulate_scheduling = simulate


def answer(decision: Decision) -> dict:
    """The decision as plain data: the retired nodes by name, each
    replacement's pods, instance types and requirements, and where each
    displaced pod went (a survivor by name, or ``"+<i>"`` for replacement
    i), as the confirming simulation that produced the command placed it."""
    cmd = decision.command
    if cmd is None:
        return {"retired": [], "replacements": [], "placement": {}}
    pids = frozenset(c.provider_id for c in cmd.candidates)
    sim = next((s for k, s in reversed(decision.sims) if k == pids), None)
    placement: dict = {}
    if sim is not None:
        for node in sim.results.existing_nodes:
            for p in node.scheduled_pods:
                placement.setdefault(p.metadata.name, []).append(node.name)
    replacements = []
    for i, claim in enumerate(cmd.replacements):
        for p in claim.pods:
            placement.setdefault(p.metadata.name, []).append(f"+{i}")
        replacements.append({
            "pool": claim.template.nodepool_name,
            "pods": [p.metadata.name for p in claim.pods],
            "options": [it.name for it in claim.instance_types],
            "reqs": system._plain_requirements(claim.requirements)})
    return {"retired": [c.name for c in cmd.candidates],
            "replacements": replacements, "placement": placement}
