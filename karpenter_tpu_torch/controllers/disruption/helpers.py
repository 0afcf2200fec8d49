"""Candidate discovery, budgets, and the counterfactual simulation.

Mirror of the reference's pkg/controllers/disruption/helpers.go:
`get_candidates` (:146-193) filters cluster state to disruptable nodes;
`build_disruption_budgets` (:199-254) computes per-nodepool per-reason
allowances net of nodes already disrupting; `simulate_scheduling` (:51-115)
answers "if these nodes were gone, where would their pods go?" by running
the full solver against the remaining state.

The port's copy of ``karpenter_tpu/controllers/disruption/helpers.py``
(imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.nodepool import ALL_REASONS
from karpenter_tpu_torch.controllers.disruption.types import Candidate
from karpenter_tpu_torch.utils import pod as pod_util
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


class SimulationResults:
    def __init__(self, results, candidate_pods):
        self.results = results
        self.candidate_pods = candidate_pods

    @property
    def new_claims(self):
        return self.results.new_claims

    def all_pods_scheduled(self) -> bool:
        """Every reschedulable pod from the candidates found a home
        (helpers.go:104: pods failing or landing nowhere block the
        command)."""
        placed = set()
        for claim in self.results.new_claims:
            placed.update(p.uid for p in claim.pods)
        for node in self.results.existing_nodes:
            placed.update(p.uid for p in getattr(node, "scheduled_pods", []) or [])
        return all(p.uid in placed for p in self.candidate_pods)


def simulate_scheduling(provisioner, cluster, store, candidates, inputs=None,
                        bundle=None) -> SimulationResults:
    """Counterfactual solve: cluster minus candidates (helpers.go:51).

    `inputs` optionally carries pre-assembled solver inputs (templates,
    catalog, overhead, limits, domains) from the round's snapshot cache
    (ops/consolidate.py) — valid only within one cluster-state generation,
    which the cache's `inputs_for` enforces before handing them out.

    `bundle` optionally carries the round's DisruptionSnapshot: when still
    generation-current it supplies the existing-node view directly — the
    candidate-free node set as cheap forks of tensorized prototypes
    (`sim_enodes`) and the solver's existing-node tensors as row slices of
    the shared snapshot (`derive_esnap`) — so a confirming simulation
    skips the O(E) snapshot+constructor sweep and the O(E×G) re-tensorize
    that otherwise dominate every confirm. The result is the same solve
    over the same state; the fast path only ever changes how the inputs
    are materialized, and declines to None-mapped candidates."""
    excluded = {c.provider_id for c in candidates}
    candidate_pods = [p for c in candidates for p in c.reschedulable_pods]
    pending = [p for p in store.list("pods") if pod_util.is_provisionable(p)]
    if bundle is not None and bundle.generation == cluster.consolidation_state():
        protos = bundle.sim_enodes(excluded)
        if protos is not None:
            seen = {p.uid for p in pending}
            seen.update(p.uid for p in candidate_pods)
            deleting = bundle.sim_deleting_pods(seen)
            results = provisioner.schedule(
                pods=pending + candidate_pods + deleting, state_nodes=[],
                inputs=inputs, enodes_base=protos, existing_base=bundle,
            )
            return SimulationResults(results, candidate_pods)
    state_nodes = [sn for sn in cluster.nodes() if sn.provider_id not in excluded]
    deleting = provisioner.deleting_node_pods(state_nodes, pending + candidate_pods)
    results = provisioner.schedule(
        pods=pending + candidate_pods + deleting, state_nodes=state_nodes,
        inputs=inputs,
    )
    return SimulationResults(results, candidate_pods)
