"""Preemption counterfactuals: evict lower tiers to admit a higher one.

When the tiered cascade leaves a high-tier pod unschedulable, this module
asks — per existing node — "if this node's evictable lower-tier victims
were gone, would the pod land on it?" as ONE batched counterfactual
dispatch with the exact row shape the consolidation probe compiles
(``ops/consolidate.py dispatch_counterfactual_rows``): the shared
tensorized snapshot plus per-row deltas, here an ``e_free`` capacity
release instead of a zeroed column. Probe answers are SEEDS: the winning
node is confirmed by a real simulation — the host admission pipeline
(``ExistingNode.add``: taints, ports, requirements, topology, float64
fit) against a fork whose victims' capacity is released — before any
eviction ships. Evictions go through the store's PDB-gated eviction
subresource (the same primitive the drain path uses), and the preemptor
is NOMINATED onto the freed node so the binder lands it as capacity
frees (pod.nominated_node_name, the reference's nomination protocol).

Victim candidate rules (the satellite contract):

* effective priority strictly below the preemptor's;
* reschedulable (daemonset/static/terminal pods never count);
* NOT ``preemption_policy="Never"`` — on either side: a Never PREEMPTOR
  never triggers the ladder, and a Never VICTIM is exempt from the set;
* PDB-respecting (a pod whose PDB allows zero disruptions is exempt, and
  the eviction subresource re-checks at execute — no TOCTOU eviction);
* no drain-in-flight double-eviction: nodes marked for deletion or
  deleting (an executing consolidation/drain command) never contribute
  victims — their pods are already being rescheduled — and nodes that won
  an earlier preemption this round leave the candidate pool (their freed
  capacity is promised to that preemptor).

The port's copy of ``karpenter_tpu/admission/preempt.py`` (imports
changed). The probes run the port's ``dispatch_counterfactual_rows`` on
the device the caller names, CUDA when it names none (raising without a
card, as ``TorchSolver()`` does; ``device="cpu"`` is the plain PyTorch
path): on the card each row's compat product is the CUDA kernel. The JAX
package's "return None when ``import jax`` fails" is gone: an
inexpressible scenario still returns None, and a device fault
propagates. Each probe dispatch runs in a ``preempt.dispatch`` span
(``device``) and records the seam's replay capture (obs/capsule.py).
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.admission.fork import fork_enode, fork_topology
from karpenter_tpu_torch.admission.priority import preemption_policy_of
from karpenter_tpu_torch.utils import pod as pod_util
from karpenter_tpu_torch.utils import resources as resutil

__all__ = ["victim_sets", "probe_feasible", "probe_feasible_batch",
           "confirm", "execute_evictions", "PreemptionCandidate"]


class PreemptionCandidate:
    """One node's evictable victim bundle for one preemptor. Victims are
    kept in eviction order — lowest priority first (the scheduler's
    preemption heuristic), name-tie-broken for determinism — so the
    confirm stage can trim to the MINIMAL prefix that admits the pod."""

    def __init__(self, enode, victims: list, prio_of: dict):
        self.enode = enode
        self.victims = sorted(
            victims,
            key=lambda v: (prio_of.get(v.uid, 0), v.metadata.name))
        self.release = resutil.merge(
            *[v.effective_requests() for v in victims])
        # eviction-cost order mirroring the scheduler's preemption
        # heuristic: disturb the least-important, smallest victim set
        self.cost = (
            max(prio_of.get(v.uid, 0) for v in victims),
            len(victims),
            sum(self.release.values()),
        )

    def trimmed(self, k: int) -> "PreemptionCandidate":
        out = object.__new__(PreemptionCandidate)
        out.enode = self.enode
        out.victims = self.victims[:k]
        out.release = resutil.merge(
            *[v.effective_requests() for v in out.victims])
        out.cost = self.cost
        return out

    @property
    def node_name(self) -> str:
        return self.enode.state_node.name


def victim_sets(preemptor, enodes, prio_of: dict, classes: dict,
                pdb_limits, taken: set) -> list:
    """Per-node evictable victim bundles, cheapest first. ``taken`` holds
    node names already promised to earlier preemptors this round.

    ``prio_of`` covers the round's PENDING batch; bound victims are
    resolved here through the same PriorityClass matrix — defaulting them
    to 0 would turn higher-priority bound workloads into "lower-tier"
    victims, the exact inversion the strictly-lower contract forbids."""
    from karpenter_tpu_torch.admission.priority import (
        default_class,
        resolve_priority,
    )

    my_prio = prio_of[preemptor.uid]
    dflt = default_class(classes)
    prio_of = dict(prio_of)

    def _prio(v) -> int:
        p = prio_of.get(v.uid)
        if p is None:
            p = prio_of[v.uid] = resolve_priority(v, classes, dflt)[0]
        return p

    out = []
    for en in enodes:
        sn = getattr(en, "state_node", None)
        if sn is None or not getattr(sn, "provider_id", ""):
            continue  # claim residuals and facades never host victims
        if sn.provider_id.startswith("claim://"):
            continue
        if sn.marked_for_deletion or sn.deleting():
            continue  # drain-in-flight: no double-eviction
        if sn.name in taken:
            continue
        victims = []
        for v in sn.pods.values():
            if _prio(v) >= my_prio:
                continue
            if not pod_util.is_reschedulable(v):
                continue
            if preemption_policy_of(v, classes) == "Never":
                continue  # Never victims are exempt from candidate sets
            if pdb_limits is not None and pdb_limits.can_evict(v) is not None:
                continue
            victims.append(v)
        if victims:
            out.append(PreemptionCandidate(en, victims, prio_of))
    out.sort(key=lambda c: c.cost)
    return out


def _capture(shared_np, g_count_k, e_avail, e_zero_cols, e_free, placed_g,
             used, max_minv, Gp, Ep):
    """The ``preempt.dispatch`` replay capture (obs/capsule.py): the
    numpy snapshot, the rows with their per-row releases as sidecars, and
    the host outputs, in the JAX package's layout."""
    from karpenter_tpu_torch.obs import capsule
    from karpenter_tpu_torch.ops.consolidate import row_capture_inputs

    if not capsule.capture_enabled():
        return
    capsule.record_capture(
        "preempt.dispatch",
        row_capture_inputs(shared_np, g_count_k, e_avail, e_zero_cols,
                           e_free=e_free),
        {"placed_g": placed_g, "used": used},
        engine="device", max_minv=max_minv, Gp=Gp, Ep=Ep)


def probe_feasible(preemptor, candidates: list, templates, its,
                   daemon_overhead=None, device=None) -> list | None:
    """One batched counterfactual dispatch over every candidate node:
    row i releases candidate i's victims on its own column and asks
    whether the preemptor lands WITHOUT opening a fresh bin (it was just
    proven unschedulable with every bin-opening option available, so
    landing == landing on freed capacity). Returns a bool list over
    ``candidates``, or None when the scenario is inexpressible (the
    caller then confirms candidates directly, cheapest first). The rows
    run on ``device`` (CUDA when None)."""
    from karpenter_tpu_torch.ops import kernels
    from karpenter_tpu_torch.ops.consolidate import (
        _pow2,
        dispatch_counterfactual_rows,
    )
    from karpenter_tpu_torch.ops.tensorize import (
        device_eligible,
        kernel_args,
        tensorize,
        tensorize_existing,
    )

    device = kernels.resolve_device(device, "the preemption probes")
    if not candidates:
        return []
    if not device_eligible(preemptor):
        return None
    enodes = [c.enode for c in candidates]
    snap = tensorize([preemptor], templates, its,
                     daemon_overhead=daemon_overhead)
    if snap.G != 1:
        return None
    esnap = tensorize_existing(snap, enodes)
    Gp = _pow2(snap.G)
    Ep = _pow2(esnap.E)
    Tp = _pow2(snap.T)
    shared_np = kernel_args(snap, esnap, Gp=Gp, Tp=Tp, Ep=Ep,
                            include_counts=False)
    shared = kernels.from_kernel_args(shared_np, device)
    R = len(snap.resources)
    rows = len(candidates)
    g_count_k = np.zeros((rows, Gp), dtype=np.int32)
    g_count_k[:, 0] = 1
    e_zero_cols = [None] * rows
    e_free = []
    for i, cand in enumerate(candidates):
        delta = np.zeros(R, dtype=np.float32)
        for r, v in cand.release.items():
            if r in snap.resources:
                delta[snap.resources.index(r)] = v
        e_free.append((i, delta))
    max_minv = int(snap.m_minv.max()) if snap.m_minv.size else 0
    with obs.span("preempt.dispatch", rows=rows, kind="device"):
        placed_g, used = dispatch_counterfactual_rows(
            shared, Gp, Ep, esnap.e_avail, max_minv, g_count_k,
            e_zero_cols, e_free=e_free)
    _capture(shared_np, g_count_k, esnap.e_avail, e_zero_cols, e_free,
             placed_g, used, max_minv, Gp, Ep)
    return [bool(placed_g[i, 0] >= 1 and used[i] == 0)
            for i in range(rows)]


def probe_feasible_batch(preemptors: list, cand_lists: list, templates,
                         its, daemon_overhead=None,
                         device=None) -> list | None:
    """The whole eviction ladder's counterfactuals in ONE dispatch: every
    (preemptor, candidate-node) pair becomes one row of the shared
    ``dispatch_counterfactual_rows`` batch — the row releases that
    candidate's victims on its own column and activates only that
    preemptor's group in the count mask. Rows share one tensorized
    snapshot over ALL preemptors and the union of their candidate nodes,
    so a 16-preemptor round pays one kernel cadence instead of sixteen
    (the fused cluster round's preemption leg — deploy/README.md).

    Returns per-preemptor bool lists aligned with ``cand_lists``, or None
    when the batch is inexpressible (the caller probes per preemptor). The
    rows run on ``device`` (CUDA when None)."""
    from karpenter_tpu_torch.ops import kernels
    from karpenter_tpu_torch.ops.consolidate import (
        _pow2,
        dispatch_counterfactual_rows,
    )
    from karpenter_tpu_torch.ops.tensorize import (
        device_eligible,
        kernel_args,
        tensorize,
        tensorize_existing,
    )

    device = kernels.resolve_device(device, "the preemption probes")
    pairs = [(j, c) for j, cands in enumerate(cand_lists) for c in cands]
    if not pairs:
        return [[] for _ in cand_lists]
    if not all(device_eligible(p) for p in preemptors):
        return None
    snap = tensorize(list(preemptors), templates, its,
                     daemon_overhead=daemon_overhead)
    gidx = {p.uid: g for g, pods_g in enumerate(snap.groups)
            for p in pods_g}
    if any(p.uid not in gidx for p in preemptors):
        return None
    enodes, col_of = [], {}
    for _, cand in pairs:
        if id(cand.enode) not in col_of:
            col_of[id(cand.enode)] = len(enodes)
            enodes.append(cand.enode)
    esnap = tensorize_existing(snap, enodes)
    Gp = _pow2(snap.G)
    Ep = _pow2(esnap.E)
    Tp = _pow2(snap.T)
    shared_np = kernel_args(snap, esnap, Gp=Gp, Tp=Tp, Ep=Ep,
                            include_counts=False)
    shared = kernels.from_kernel_args(shared_np, device)
    R = len(snap.resources)
    rows = len(pairs)
    g_count_k = np.zeros((rows, Gp), dtype=np.int32)
    e_zero_cols = [None] * rows
    e_free = []
    for i, (j, cand) in enumerate(pairs):
        g_count_k[i, gidx[preemptors[j].uid]] = 1
        col = col_of[id(cand.enode)]
        delta = np.zeros(R, dtype=np.float32)
        for r, v in cand.release.items():
            if r in snap.resources:
                delta[snap.resources.index(r)] = v
        e_free.append((col, delta))
    max_minv = int(snap.m_minv.max()) if snap.m_minv.size else 0
    with obs.span("preempt.dispatch", rows=rows, kind="device",
                  preemptors=len(preemptors)):
        placed_g, used = dispatch_counterfactual_rows(
            shared, Gp, Ep, esnap.e_avail, max_minv, g_count_k,
            e_zero_cols, e_free=e_free)
    _capture(shared_np, g_count_k, esnap.e_avail, e_zero_cols, e_free,
             placed_g, used, max_minv, Gp, Ep)
    out = [[] for _ in cand_lists]
    for i, (j, _) in enumerate(pairs):
        g = gidx[preemptors[j].uid]
        out[j].append(bool(placed_g[i, g] >= 1 and used[i] == 0))
    return out


def confirm(preemptor, candidate: PreemptionCandidate, topology) -> bool:
    """The probe-confirm contract's real simulation: fork the node, add
    the victims' capacity back, and run the preemptor through the host
    admission pipeline. Victims still count in the forked topology's
    domain maps — conservative (an anti-affinity conflict with a
    to-be-evicted victim declines the preemption rather than racing it)."""
    topo = fork_topology(topology)
    node = fork_enode(candidate.enode, topo)
    node.cached_available = resutil.merge(
        dict(node.cached_available), candidate.release)
    clone = preemptor.clone()
    return node.add(clone) is None


def trim_and_confirm(preemptor, candidate: PreemptionCandidate,
                     topology) -> "PreemptionCandidate | None":
    """The MINIMAL confirmed victim set on this node: the shortest prefix
    of the eviction order (lowest priority first) whose release the real
    simulation confirms — the probe's full-bundle row is a feasibility
    seed, never the eviction warrant. None when even the full bundle
    fails the confirm (probe-vs-host disagreement). Feasibility is
    monotone in the prefix (more released capacity never hurts the
    admission pipeline), so a binary search pays O(log V) confirms —
    each confirm forks the round topology, which a linear walk over a
    many-victim node would repeat per step."""
    V = len(candidate.victims)
    if V == 0 or not confirm(preemptor, candidate, topology):
        return None
    lo, hi = 1, V  # invariant: hi confirms, prefixes < lo are untested
    while lo < hi:
        mid = (lo + hi) // 2
        if confirm(preemptor, candidate.trimmed(mid), topology):
            hi = mid
        else:
            lo = mid + 1
    return candidate.trimmed(hi)


def execute_evictions(store, candidate: PreemptionCandidate, preemptor,
                      recorder=None, registry=None) -> tuple:
    """Ship the confirmed preemption: evict every victim through the
    store's PDB-gated eviction subresource and — only when the WHOLE
    minimal set shipped — nominate the preemptor onto the freed node.
    Returns ``(evicted, complete)``: a PDB that closed since the filter
    ran aborts the remaining victims (no TOCTOU race), and an incomplete
    set must not nominate — the trimmed prefix was minimal by
    construction, so partial room cannot fit the preemptor (the already-
    evicted victims' capacity returns to the general pool next round)."""
    from karpenter_tpu_torch.kube.store import NotFoundError, TooManyRequests
    from karpenter_tpu_torch.operator import metrics as m

    evicted = 0
    complete = True
    for v in candidate.victims:
        try:
            store.evict(v)
        except TooManyRequests:
            complete = False
            break
        except NotFoundError:
            # the victim vanished since the filter ran (a concurrent
            # termination finished the job): its capacity is already
            # free — the set is still satisfied, nothing to evict or
            # publish for this slot
            continue
        evicted += 1
        if recorder is not None:
            recorder.publish(
                "Preempted",
                f"pod {v.key()} preempted by {preemptor.key()} "
                f"on {candidate.node_name}",
                obj=v,
            )
    if evicted and registry is not None:
        registry.counter(
            m.ADMISSION_EVICTIONS,
            "victim pods evicted by confirmed admission preemptions",
        ).inc(evicted)
    if complete:
        # a complete set nominates even at zero evictions (every victim
        # vanished on its own — the confirmed capacity is free either way)
        preemptor.nominated_node_name = candidate.node_name
        store.update("pods", preemptor)
    return evicted, complete
