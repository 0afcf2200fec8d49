"""The live kind's system under test: one provisioning decision of
``karpenter_tpu_torch`` onto a running cluster.

The only module of this kind that imports the program. Each plain input
of ``portbench/live.py`` is built as the program's objects by
``disrupt.Fleet``: a ``KubeStore`` holding the NodePool, the running
nodes (launched, registered and initialized) and their bound pods, a
``Cluster`` fed the store's events, and a ``Provisioner`` over the run's
one ``TorchSolver``. The running pods then take the labels the plain
cluster gives them (``Fleet`` builds pods without labels), and the burst
joins the store as pending pods marked unschedulable, as kube-scheduler
leaves a pod that no node takes. The configuration's NodePool states no
disruption settings; the fleet's NodePool is given the NodePool's own
defaults, which no provisioning decision reads.

A decision (``Program.decide``) is ``Provisioner.schedule()`` with no
arguments under the ``provision`` round trace, as the provisioner's
reconcile opens it: the pending pods listed from the store, the state
nodes from the cluster, the round's ``Topology`` over the cluster view
(``provision.topology``), one ``ExistingNode`` per node
(``provision.existing``), the solve, and a synchronise of the card. It
ends at the ``SchedulerResults``: no claim is created and no pod is
bound, so the cluster stands as it was, and ``Live.reset`` hands the
next decision every pod, node, NodeClaim and StateNode as made.

The answer is read from the decision's own results, never solved again:
the new claims as ``system.answer`` gives them, and for each existing
node the burst pods placed there (``existing``).
"""

from __future__ import annotations

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.api.nodepool import NodePool
from karpenter_tpu_torch.models.solver import TorchSolver

from portbench import disrupt, system

# the condition kube-scheduler sets on a pod no node can take, which makes
# it provisionable (utils/pod.py failed_to_schedule)
UNSCHEDULABLE = {"type": "PodScheduled", "status": "False", "reason": "Unschedulable"}


def _fleet_cfg(cfg: dict) -> dict:
    """The configuration with the NodePool's own disruption defaults on
    every NodePool that states none, as ``disrupt.Fleet`` reads them."""
    d = NodePool().spec.disruption
    defaults = {"consolidation_policy": d.consolidation_policy,
                "consolidate_after": d.consolidate_after,
                "budget": d.budgets[0].nodes}
    return dict(cfg, nodepools=[dict(p, disruption=p.get("disruption", defaults))
                                for p in cfg["nodepools"]])


class Live:
    """One plain input as the program's objects: the running cluster, the
    burst pending in its store (``pods``), and the state a decision may
    memoise on them as it was made: ``reset`` restores every pod, node and
    NodeClaim of the store and every StateNode of the cluster to it."""

    def __init__(self, plain: dict, cfg: dict, its: list, solver):
        self.plain = plain
        fleet = disrupt.Fleet(plain, _fleet_cfg(cfg), its, solver, options={})
        store, cluster = fleet.store, fleet.cluster
        labels = {p["name"]: p["labels"] for p in plain["pods"]}
        for pod in fleet.pods:
            pod.metadata.labels = dict(labels[pod.metadata.name])
        self.pods = system.pods(plain["burst"])
        for pod in self.pods:
            pod.conditions = [dict(UNSCHEDULABLE)]
            store.create("pods", pod)
        for event in store.drain_events():
            cluster.on_event(event)
        self.store, self.cluster, self.provisioner = store, cluster, fleet.provisioner
        self._objects = (store.list("pods") + store.list("nodes") + store.list("nodeclaims")
                         + list(cluster.state_nodes()) + [cluster])
        self._made = [dict(o.__dict__) for o in self._objects]

    def reset(self) -> None:
        """The cluster and the burst as they were made."""
        for obj, made in zip(self._objects, self._made):
            d = obj.__dict__
            d.clear()
            d.update(made)


class Program:
    """The program set up for one configuration: its instance types and
    one ``TorchSolver`` on ``device``."""

    def __init__(self, cfg: dict, plain_catalog: list, traffic: dict, device=None):
        self.cfg = cfg
        self.its = system.instance_types(cfg, plain_catalog)
        self.solver = TorchSolver(device=device)
        self.cuda = self.solver.device.type == "cuda"

    def batch(self, plain: dict) -> Live:
        return Live(plain, self.cfg, self.its, self.solver)

    def decide(self, live: Live):
        """One provisioning round over ``live``'s cluster; returns the
        ``SchedulerResults`` and the round's trace (None with the tracer
        off)."""
        import torch

        with obs.round_trace("provision") as trace:
            results = live.provisioner.schedule()
            if self.cuda:
                torch.cuda.synchronize()
        return results, (trace if isinstance(trace, obs.Trace) else None)

    @staticmethod
    def answer(results) -> dict:
        return answer(results)

    @staticmethod
    def tally(results) -> tuple:
        """(burst pods placed, on new claims or existing nodes; pods
        reported unschedulable) of a decision."""
        return (sum(len(c.pods) for c in results.new_claims)
                + sum(len(n.pods) for n in results.existing_nodes),
                len(results.pod_errors))

    @property
    def engine(self) -> str | None:
        """The engine of the last solve (``last_device_stats``)."""
        return self.solver.last_device_stats.get("engine")

    compat_launches = staticmethod(system.compat_launches)
    record_compat = staticmethod(system.record_compat)


def answer(results) -> dict:
    """The decision as plain data: ``system.answer``'s claims and errors,
    and the burst pods placed on each existing node, by name."""
    out = system.answer(results)
    out["existing"] = {n.state_node.name: [p.metadata.name for p in n.pods]
                       for n in results.existing_nodes if n.pods}
    return out
