"""The system under test: ``karpenter_tpu_torch``'s provisioning decision.

The only module of the harness that imports the program. It builds the
program's objects from the plain data of ``portbench/gen.py`` (the
instance types with the program's own constructor, one ``ClaimTemplate``
per NodePool, ``Pod`` objects), runs one decision as the provisioner runs
it, and turns the program's ``SchedulerResults`` back into plain data for
the reference to judge.

A decision (``Program.decide``) is one traced round (``obs.round_trace``,
as the provisioner's reconcile wraps its round): in a topology mix the
round's ``Topology`` over the templates' domains and the batch, then
``TorchSolver.solve`` on the default CUDA device with the engine ladder at
its defaults, then a synchronise of the card.
"""

from __future__ import annotations

import contextlib

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.nodepool import NodePool
from karpenter_tpu_torch.api.objects import (
    Affinity,
    LabelSelector,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.cloudprovider.catalog import make_instance_type
from karpenter_tpu_torch.cloudprovider.types import (
    InstanceType,
    InstanceTypeOverhead,
    Offering,
    Offerings,
)
from karpenter_tpu_torch.controllers.provisioning.provisioner import collect_domains
from karpenter_tpu_torch.models.inflight import ClaimTemplate
from karpenter_tpu_torch.models.solver import TorchSolver
from karpenter_tpu_torch.models.topology import Topology
from karpenter_tpu_torch.scheduling import IN, Requirement, Requirements

GIB = 2**30
MIB = 2**20


def instance_types(cfg: dict, plain_catalog: list) -> list:
    """The program's ``InstanceType`` objects for the plain catalog: by its
    own ``make_instance_type`` for ``benchmark_catalog``'s cycle, and from
    its requirement and offering types for upstream's fake instance types,
    which that constructor cannot state (spot in fewer zones than
    on-demand, three operating systems, a fixed kube-reserved)."""
    kind = cfg["catalog"]["kind"]
    if kind == "benchmark_catalog":
        return [
            make_instance_type(
                t["name"], cpu=t["cpu"], mem_gib=t["mem_gib"], arch=t["arch"],
                zones=tuple(t["zones"]), capacity_types=tuple(t["capacity_types"]),
                family=cfg["catalog"]["family"], pods=t["pods"], os=t["oses"][0],
                price_override=t["price"])
            for t in plain_catalog
        ]
    reserved = cfg["catalog"]["kube_reserved"]
    overhead = {"cpu": reserved["cpu"], "memory": reserved["memory_mib"] * MIB}
    out = []
    for t in plain_catalog:
        reqs = Requirements(
            Requirement(wk.INSTANCE_TYPE_LABEL, IN, [t["name"]]),
            Requirement(wk.ARCH_LABEL, IN, [t["arch"]]),
            Requirement(wk.OS_LABEL, IN, list(t["oses"])),
            Requirement(wk.TOPOLOGY_ZONE_LABEL, IN, list(t["zones"])),
            Requirement(wk.CAPACITY_TYPE_LABEL, IN, list(t["capacity_types"])),
            *(Requirement(k, IN, [v]) for k, v in t["labels"].items()))
        offerings = Offerings(
            Offering(requirements=Requirements(
                Requirement(wk.CAPACITY_TYPE_LABEL, IN, [ct]),
                Requirement(wk.TOPOLOGY_ZONE_LABEL, IN, [zone])),
                price=t["price"], available=True)
            for ct, zone in t["offerings"])
        capacity = {"cpu": float(t["cpu"]), "memory": float(t["mem_gib"] * GIB),
                    "pods": float(t["pods"])}
        out.append(InstanceType(t["name"], reqs, offerings, capacity,
                                InstanceTypeOverhead(kube_reserved=dict(overhead))))
    return out


def templates(cfg: dict) -> list:
    out = []
    for p in cfg["nodepools"]:
        pool = NodePool(metadata=ObjectMeta(name=p["name"]))
        pool.spec.weight = p["weight"]
        out.append(ClaimTemplate(pool))
    return out


def _selector(match: dict) -> LabelSelector:
    return LabelSelector(match_labels=dict(match))


def pods(plain: list) -> list:
    """``Pod`` objects of a plain batch. Replicas of one stamp share their
    ``requests`` and ``node_selector`` dicts, as a Deployment stamps its
    replicas; every other pod owns its own."""
    shared: dict = {}
    out = []
    for p in plain:
        spec = shared.get(p["stamp"]) if p["stamp"] is not None else None
        if spec is None:
            spec = ({"cpu": p["cpu"], "memory": float(p["mem"])},
                    dict(p["selector"]))
            if p["stamp"] is not None:
                shared[p["stamp"]] = spec
        affinity = None
        if p["affinity"] or p["anti"]:
            terms = lambda ts: PodAffinity(required=[  # noqa: E731
                PodAffinityTerm(topology_key=t["key"],
                                label_selector=_selector(t["match"]))
                for t in ts]) if ts else None
            affinity = Affinity(pod_affinity=terms(p["affinity"]),
                                pod_anti_affinity=terms(p["anti"]))
        out.append(Pod(
            metadata=ObjectMeta(name=p["name"], labels=dict(p["labels"])),
            requests=spec[0], node_selector=spec[1], affinity=affinity,
            topology_spread_constraints=[
                TopologySpreadConstraint(
                    max_skew=s["skew"], topology_key=s["key"],
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=_selector(s["match"]))
                for s in p["spread"]]))
    return out


class Batch:
    """One batch of the ring as the program's pods, and each pod's state as
    it was made: a solve memoises work on the pod objects (signatures,
    eligibility), which a fresh batch of pending pods never has, so
    ``reset`` hands every decision the pods as they were made."""

    def __init__(self, plain: list):
        self.plain = plain
        self.pods = pods(plain)
        self._made = [dict(p.__dict__) for p in self.pods]

    def reset(self) -> None:
        for pod, made in zip(self.pods, self._made):
            d = pod.__dict__
            d.clear()
            d.update(made)


class Program:
    """The program set up for one configuration: its instance types by
    NodePool, its templates and one ``TorchSolver`` on ``device``."""

    def __init__(self, cfg: dict, plain_catalog: list, topology: bool,
                 device=None):
        its = instance_types(cfg, plain_catalog)
        self.templates = templates(cfg)
        self.its = {t.nodepool_name: its for t in self.templates}
        self.topology = topology
        self.solver = TorchSolver(device=device)
        self.cuda = self.solver.device.type == "cuda"

    def decide(self, batch: Batch):
        """One provisioning decision over ``batch``; returns the
        ``SchedulerResults`` and the round's trace (None with the tracer
        off)."""
        import torch

        with obs.round_trace("provision") as trace:
            topology = None
            if self.topology:
                domains: dict = {}
                for t in self.templates:
                    collect_domains(domains, t, self.its[t.nodepool_name])
                topology = Topology(domains=domains, pods=batch.pods)
            results = self.solver.solve(batch.pods, self.templates, self.its,
                                        topology=topology)
            if self.cuda:
                torch.cuda.synchronize()
        return results, (trace if isinstance(trace, obs.Trace) else None)

    @staticmethod
    def batch(plain: list) -> Batch:
        return Batch(plain)

    @staticmethod
    def answer(results) -> dict:
        return answer(results)

    @staticmethod
    def tally(results) -> tuple:
        """(pods placed, pods reported unschedulable) of a decision."""
        return sum(len(c.pods) for c in results.new_claims), len(results.pod_errors)

    @property
    def engine(self) -> str | None:
        """The engine of the last decision (``last_device_stats``)."""
        return self.solver.last_device_stats.get("engine")

    @staticmethod
    def compat_launches() -> int:
        return compat_launches()

    @staticmethod
    def record_compat(calls: list):
        return record_compat(calls)


def _plain_requirements(reqs) -> dict:
    """{key: [complement, sorted values]} of a ``Requirements``."""
    return {k: [bool(r.complement), sorted(r.values)] for k, r in reqs.items()}


def answer(results) -> dict:
    """The program's answer as plain data: each claim's nodepool, pods by
    name, instance types by name and requirements; the pods reported
    unschedulable, by name."""
    claims = [{
        "pool": c.template.nodepool_name,
        "pods": [p.metadata.name for p in c.pods],
        "options": [it.name for it in c.instance_types],
        "reqs": _plain_requirements(c.requirements),
    } for c in results.new_claims]
    errors = sorted(k.split("/", 1)[-1] for k in results.pod_errors)
    return {"claims": claims, "errors": errors}



def compat_launches() -> int:
    """The program's own count of compat kernel launches
    (``ops/cuda_kernels.py`` ``LAUNCHES``)."""
    from karpenter_tpu_torch.ops import cuda_kernels

    return cuda_kernels.LAUNCHES["compat"]


@contextlib.contextmanager
def record_compat(calls: list):
    """Within the block, append ``(G, T, K, W, g_has, t_has)`` of every
    compat call the pack loop makes on the card (``ops/kernels.py`` calls
    ``compat`` by that module's name)."""
    from karpenter_tpu_torch.ops import kernels

    launch = kernels.compat

    def recorded(g_mask, g_has, g_tol, t_mask, t_has, t_tol):
        out = launch(g_mask, g_has, g_tol, t_mask, t_has, t_tol)
        if g_mask.is_cuda:
            G, K, W = g_mask.shape
            calls.append((G, t_mask.shape[0], K, W, g_has, t_has))
        return out

    kernels.compat = recorded
    try:
        yield
    finally:
        kernels.compat = launch
