"""Candidate discovery and budgets.

Mirror of the reference's pkg/controllers/disruption/helpers.go:
`get_candidates` (:146-193) filters cluster state to disruptable nodes;
`build_disruption_budgets` (:199-254) computes per-nodepool per-reason
allowances net of nodes already disrupting.

The port's copy of part of ``karpenter_tpu/controllers/disruption/
helpers.py`` (imports changed). ``simulate_scheduling``, the confirming
counterfactual solve, needs ``Provisioner.schedule`` and comes with the
disruption controller (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.nodepool import ALL_REASONS
from karpenter_tpu_torch.controllers.disruption.types import Candidate
from karpenter_tpu_torch.utils.pdb import PdbLimits


def get_candidates(cluster, store, cloud, clock, queue=None,
                   catalog_cache=None) -> list:
    """Disruptable nodes as Candidates (helpers.go:146).

    ``catalog_cache`` optionally carries a nodepool-name -> {type name:
    InstanceType} memo owned by the disruption controller: candidate
    discovery runs at least twice per executed command (compute +
    validate) and every poll round otherwise, and re-listing the cloud
    provider each time is pure waste for providers where GetInstanceTypes
    is a real API call. The controller clears it on nodepool events; the
    catalog objects themselves are shared by identity with the solver's
    type cache, so in-place offering flips stay visible."""
    pdb_limits = PdbLimits(store)
    pools = {np.name: np for np in store.list("nodepools")}
    catalogs: dict = catalog_cache if catalog_cache is not None else {}
    out = []
    for sn in cluster.nodes():
        if sn.deleting() or sn.marked_for_deletion:
            continue
        if queue is not None and queue.has_candidate(sn.provider_id):
            continue
        if sn.nominated(clock.now()):
            continue
        if sn.validate_disruptable(pdb_limits) is not None:
            continue
        np = pools.get(sn.nodepool_name)
        if np is None:
            continue
        if np.name not in catalogs:
            catalogs[np.name] = {it.name: it for it in cloud.get_instance_types(np)}
        it = catalogs[np.name].get(sn.labels().get(wk.INSTANCE_TYPE_LABEL, ""))
        out.append(Candidate(sn, np, it, clock))
    return out


def build_disruption_budgets(cluster, store, clock) -> dict:
    """nodepool name -> reason -> allowed disruptions (helpers.go:199)."""
    totals: dict = {}
    disrupting: dict = {}
    # read-only aggregation: the live StateNodes suffice — no snapshot copy
    for sn in cluster.state_nodes():
        pool = sn.nodepool_name
        if not pool:
            continue
        totals[pool] = totals.get(pool, 0) + 1
        if sn.marked_for_deletion or sn.deleting() or not sn.initialized():
            disrupting[pool] = disrupting.get(pool, 0) + 1
    budgets: dict = {}
    now = clock.now()
    for np in store.list("nodepools"):
        total = totals.get(np.name, 0)
        already = disrupting.get(np.name, 0)
        budgets[np.name] = {
            reason: max(np.allowed_disruptions(reason, total, now) - already, 0)
            for reason in ALL_REASONS
        }
    return budgets


def within_budget(budgets: dict, reason: str, candidates) -> list:
    """Longest prefix of candidates whose per-pool budgets all hold
    (the reference trims candidate lists per nodepool budget)."""
    spent: dict = {}
    out = []
    for c in candidates:
        pool = c.node_pool.name
        allowed = budgets.get(pool, {}).get(reason, 0)
        if spent.get(pool, 0) + 1 > allowed:
            continue
        spent[pool] = spent.get(pool, 0) + 1
        out.append(c)
    return out
