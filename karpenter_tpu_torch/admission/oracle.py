"""Tiered-FFD host oracle: the admission plane's parity reference.

A deliberately-plain sequential implementation of the admission
semantics — per-tier FFD (the reference scheduler loop, HostSolver) with
prior tiers' claims threaded as ``initial_claims``, gangs trialed on
forked state and promoted atomically — independent of plane.py's
orchestration code. ``chip_smoke.py``'s admission phase gates the
device round's node count against it (≤ oracle + 2%).

The oracle owns no store and never preempts — it answers "how many nodes
does a faithful sequential tiered FFD open, and which pods land" for the
same inputs the cascade consumed.

The port's copy of ``karpenter_tpu/admission/oracle.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.admission.fork import (
    fork_claim,
    fork_enode,
    fork_limits,
    fork_topology,
)
from karpenter_tpu_torch.admission.gangs import collect_gangs, inject_colocation
from karpenter_tpu_torch.admission.priority import (
    effective_priorities,
    partition_tiers,
)
from karpenter_tpu_torch.models.scheduler import SchedulerResults, subtract_max
from karpenter_tpu_torch.models.solver import HostSolver

__all__ = ["tiered_ffd_oracle", "debit_limits"]


def debit_limits(limits, new_claims):
    """Cross-tier nodepool-limit accounting (scheduler.go:292 subtractMax
    applied between solves): each finished tier's claims debit the
    remaining limits the next tier sees. Shared verb with plane.py so the
    cascade and the oracle can never drift on the arithmetic."""
    if not limits:
        return limits
    for claim in new_claims:
        pool = claim.template.nodepool_name
        if pool in limits and claim.instance_types:
            limits[pool] = subtract_max(limits[pool], claim.instance_types)
    return limits


def placed_uids(claims, enodes) -> set:
    """Every pod uid the given claims + existing nodes report placed —
    the ONE membership helper the cascade, the oracle, and the perf rows
    all share (ClaimResidual's empty scheduled_pods included), so a
    placement-reporting change can never desynchronize the parity gates."""
    placed = {p.uid for c in claims for p in c.pods}
    for node in enodes:
        placed.update(
            p.uid for p in getattr(node, "scheduled_pods", None) or [])
    return placed


def _complete(res, pods) -> bool:
    placed = placed_uids(res.new_claims, res.existing_nodes)
    return all(p.uid in placed for p in pods)


def tiered_ffd_oracle(pods, templates, its, *, classes=None,
                      topology=None, existing_nodes=(),
                      daemon_overhead=None, limits=None,
                      volume_topology=None):
    """(SchedulerResults, report) for the sequential per-tier host FFD."""
    classes = classes or {}
    prio_of = effective_priorities(pods, classes)
    gangs, loose = collect_gangs(pods, prio_of)
    gangs_by_prio: dict = {}
    for g in gangs:
        gangs_by_prio.setdefault(g.priority, []).append(g)
    tiers_loose = dict(partition_tiers(loose, prio_of))
    all_prios = sorted(set(tiers_loose) | set(gangs_by_prio), reverse=True)

    host = HostSolver()
    claims: list = []
    enodes = list(existing_nodes)
    limits = fork_limits(limits)
    errors: dict = {}
    report = {"tiers": len(all_prios), "gangs_placed": 0, "gangs_routed": 0}
    for prio in all_prios:
        for gang in gangs_by_prio.get(prio, ()):
            if len(gang.pods) < gang.min_member:
                for p in gang.pods:
                    errors[p.key()] = (
                        f'pod group "{gang.name}" below min-member '
                        f"({len(gang.pods)} < {gang.min_member})")
                report["gangs_routed"] += 1
                continue
            topo = fork_topology(topology)
            f_enodes = [fork_enode(en, topo) for en in enodes]
            f_claims = [fork_claim(c, topo) for c in claims]
            clones = inject_colocation(gang, [p.clone() for p in gang.pods])
            if gang.topology_key and topo is not None:
                for c in clones:
                    topo.update(c)
            res = host.solve(
                clones, templates, its, topology=topo,
                existing_nodes=f_enodes, daemon_overhead=daemon_overhead,
                limits=fork_limits(limits), initial_claims=f_claims,
                volume_topology=volume_topology,
            )
            if _complete(res, clones):
                new = [c for c in res.new_claims
                       if all(c is not fc for fc in f_claims)]
                originals = {p.uid: p for p in gang.pods}
                for c in res.new_claims:
                    c.pods = [originals.get(p.uid, p) for p in c.pods]
                for node in res.existing_nodes:
                    node.pods = [originals.get(p.uid, p) for p in node.pods]
                topology = topo
                enodes = f_enodes
                claims = f_claims + new
                limits = debit_limits(fork_limits(limits), new)
                report["gangs_placed"] += 1
            else:
                for p in gang.pods:
                    errors[p.key()] = (
                        f'pod group "{gang.name}" could not place atomically')
                report["gangs_routed"] += 1
        tier_pods = tiers_loose.get(prio, ())
        if not tier_pods:
            continue
        res = host.solve(
            list(tier_pods), templates, its, topology=topology,
            existing_nodes=enodes, daemon_overhead=daemon_overhead,
            limits=fork_limits(limits), initial_claims=claims,
            volume_topology=volume_topology,
        )
        new = [c for c in res.new_claims if all(c is not pc for pc in claims)]
        claims = claims + new
        limits = debit_limits(limits, new)
        errors.update(res.pod_errors)
    return SchedulerResults(
        new_claims=claims, existing_nodes=enodes, pod_errors=errors,
    ), report
