"""Cluster: the in-memory mirror of apiserver state.

Behavioral mirror of the reference's pkg/controllers/state/cluster.go:47-84:
nodes and nodeclaims merged by providerID into StateNodes, pod→node
bindings, an anti-affinity pod index, nominations, MarkedForDeletion, and a
consolidation-state timestamp (`mark_unconsolidated`/`consolidation_state`,
cluster.go:310-337). `synced()` is the superset gate (cluster.go:85-127):
every apiserver NodeClaim/Node must be represented in memory before the
provisioner or the disruption controller may solve.

Events flow in through `on_event` (the informer layer,
state/informer/{pod,node,nodeclaim}.go collapsed into one method — our
hermetic runtime has a single watch stream).

The port's copy of ``karpenter_tpu/state/cluster.py`` with its imports
changed. Left out: the fleet-ledger timeline events, interruption notices
and the delta journal's wire form (the solver service's), none of which
the disruption snapshot reads.
"""

from __future__ import annotations

import collections
import itertools

from karpenter_tpu_torch.state.statenode import StateNode
from karpenter_tpu_torch.utils import pod as pod_util

_anon_counter = itertools.count(1)

# journal capacity: must cover every informer event between two disruption
# snapshot reads or the consumer sees a gap and rebuilds from scratch. A
# 1000-node consolidation wave generates ~4-5k events (pod deletes +
# recreates + binds + node/claim deletes) and a multi-round 2000-node
# convergence ~5k per ROUND — a 16k cap aged out mid-convergence and
# forced exactly the full re-tensorization the delta path exists to
# avoid (the fused round's tensorize lever; bench.py gates the wave at
# zero gap-rebuilds), so the default covers several such waves while
# still bounding memory to one deque of small tuples (~6 MB worst case).
DELTA_JOURNAL_CAP = 65536


def _journal_cap() -> int:
    from karpenter_tpu_torch.utils.envknobs import env_int

    return env_int("KARPENTER_DELTA_JOURNAL_CAP", DELTA_JOURNAL_CAP,
                   minimum=1024)


def _nodepool_sched_fingerprint(np_) -> tuple:
    """Everything on a NodePool that can change a scheduling or
    disruption answer, folded into one comparable value: the drift
    static-hash (template labels/annotations/taints/kubelet/class ref)
    plus the fields it deliberately excludes but the solver and the
    disruption ladder consume — template requirements and resource
    requests, weight, limits, the whole disruption block (policy,
    consolidate/expire windows, budgets), the status conditions
    (readiness gates which pools the provisioner solves over), and —
    only when the pool HAS limits — the aggregated usage itself
    (remaining = spec − usage feeds the solve). An event whose
    fingerprint is unchanged is status bookkeeping and must not bump
    the consolidation generation."""
    spec = np_.spec
    t = spec.template
    d = spec.disruption
    return (
        np_.static_hash(),
        repr(t.requirements),
        repr(t.resource_requests),
        spec.weight,
        repr(spec.limits),
        d.consolidation_policy,
        d.consolidate_after,
        d.expire_after,
        repr(d.budgets),
        tuple(
            (getattr(c, "type", None), getattr(c, "status", None))
            for c in np_.status.conditions
        ),
        repr(np_.status.resources) if spec.limits else None,
    )


class Cluster:
    def __init__(self, store, clock=None):
        from karpenter_tpu_torch.utils.clock import Clock

        self.store = store
        self.clock = clock or Clock()
        self._nodes: dict = {}  # provider_id -> StateNode
        self._node_name_to_pid: dict = {}  # node name -> provider_id
        self._claim_name_to_pid: dict = {}  # claim name -> provider_id
        self._bindings: dict = {}  # pod key -> node name
        self._antiaffinity_pods: dict = {}  # pod key -> Pod (bound, w/ required anti-affinity)
        self._state_seq: int = 0
        # structured delta journal: one entry per generation bump, consumed
        # by the disruption snapshot cache (ops/consolidate.py) to patch its
        # tensorized view instead of rebuilding. Entry = (seq, delta) where
        # delta is ("node", provider_id), ("pod", pod, node_name|None, gone)
        # or None (opaque: the consumer must rebuild from scratch).
        self._delta_journal: collections.deque = collections.deque(
            maxlen=_journal_cap()
        )
        # per-nodepool scheduling fingerprint (ISSUE 14): the counter
        # controller rewrites status.resources after every node wave, and
        # treating those bookkeeping writes as consolidation-relevant
        # re-opened the noop fence (and rebuilt the snapshot cache) once
        # per wave for nothing — only a fingerprint CHANGE bumps now
        self._np_fingerprints: dict = {}

    # -- informer entry point -------------------------------------------
    def on_event(self, event):
        kind, typ, obj = event.kind, event.type, event.obj
        if kind == "nodes":
            if typ == "Deleted":
                self.delete_node(obj)
            else:
                self.update_node(obj)
        elif kind == "nodeclaims":
            if typ == "Deleted":
                self.delete_node_claim(obj)
            else:
                self.update_node_claim(obj)
        elif kind == "pods":
            if typ == "Deleted":
                self.delete_pod(obj)
            else:
                self.update_pod(obj)
        elif kind == "nodepools":
            # a nodepool SPEC or readiness change can change the
            # consolidation answer (templates, requirements, budgets,
            # limits, weight — all feed the solver inputs the disruption
            # snapshot cache keys on this counter), so it bumps opaque.
            # A STATUS-only write with the scheduling fingerprint
            # unchanged — the counter controller refreshing
            # status.resources on a pool without limits after every node
            # wave — is bookkeeping: bumping for it re-opened the noop
            # fence and displaced the cached snapshot once per wave for
            # nothing. Usage still participates WHEN the pool has limits
            # (remaining = spec − usage feeds the solve).
            if typ == "Deleted":
                self._np_fingerprints.pop(obj.metadata.name, None)
                self.mark_unconsolidated()
            else:
                fp = _nodepool_sched_fingerprint(obj)
                if self._np_fingerprints.get(obj.metadata.name) != fp:
                    self._np_fingerprints[obj.metadata.name] = fp
                    self.mark_unconsolidated()
        elif kind == "daemonsets":
            # any daemonset change can change the consolidation answer
            # (daemon overhead rides the cached solver inputs)
            self.mark_unconsolidated()

    def resync(self):
        """Full rebuild from the store snapshot — leadership takeover: a
        fresh leader's informer cache must warm before it reconciles (the
        reference's client-go informers re-list on start; the hermetic
        store's event queue is single-consumer, so a standby that never
        drained catches up here)."""
        self._nodes.clear()
        self._node_name_to_pid.clear()
        self._claim_name_to_pid.clear()
        self._bindings.clear()
        self._antiaffinity_pods.clear()
        # fingerprints re-learn from the next events (a cleared entry can
        # only cause one extra opaque bump — the safe direction)
        self._np_fingerprints.clear()
        self.mark_unconsolidated()  # opaque: a rebuilt mirror has no delta
        for claim in self.store.list("nodeclaims"):
            self.update_node_claim(claim)
        for node in self.store.list("nodes"):
            self.update_node(node)
        for pod in self.store.list("pods"):
            self.update_pod(pod)

    # -- node / claim tracking (cluster.go UpdateNode/UpdateNodeClaim) ---
    def _state_for(self, provider_id: str) -> StateNode:
        if not provider_id:
            provider_id = f"anon-{next(_anon_counter)}"
        sn = self._nodes.get(provider_id)
        if sn is None:
            sn = StateNode(provider_id)
            self._nodes[provider_id] = sn
        return sn

    def update_node(self, node):
        pid = node.provider_id or node.name
        old_pid = self._node_name_to_pid.get(node.name)
        if old_pid is not None and old_pid != pid:
            old = self._nodes.get(old_pid)
            if old is not None:
                old.node = None
                self._gc(old_pid)
            self.mark_unconsolidated(("node", old_pid))
        sn = self._state_for(pid)
        sn.node = node
        self._node_name_to_pid[node.name] = pid
        self.mark_unconsolidated(("node", pid))
        return sn

    def delete_node(self, node):
        pid = self._node_name_to_pid.pop(node.name, None)
        if pid is None:
            return
        sn = self._nodes.get(pid)
        if sn is not None:
            sn.node = None
            self._gc(pid)
        self.mark_unconsolidated(("node", pid))

    def update_node_claim(self, claim):
        pid = claim.status.provider_id or claim.name
        old_pid = self._claim_name_to_pid.get(claim.name)
        if old_pid is not None and old_pid != pid:
            # claim gained its providerID: re-key (cluster.go updates by
            # provider id once launched)
            old = self._nodes.pop(old_pid, None)
            if old is not None:
                old.provider_id = pid
                existing = self._nodes.get(pid)
                if existing is not None:
                    existing.node_claim = claim
                    existing.marked_for_deletion |= old.marked_for_deletion
                else:
                    self._nodes[pid] = old
            self.mark_unconsolidated(("node", old_pid))
        sn = self._state_for(pid)
        sn.node_claim = claim
        self._claim_name_to_pid[claim.name] = pid
        self.mark_unconsolidated(("node", pid))
        return sn

    def delete_node_claim(self, claim):
        pid = self._claim_name_to_pid.pop(claim.name, None)
        if pid is None:
            return
        sn = self._nodes.get(pid)
        if sn is not None:
            sn.node_claim = None
            self._gc(pid)
        self.mark_unconsolidated(("node", pid))

    def _gc(self, pid: str):
        sn = self._nodes.get(pid)
        if sn is not None and sn.node is None and sn.node_claim is None:
            del self._nodes[pid]

    # -- pod tracking (cluster.go UpdatePod:284) -------------------------
    def update_pod(self, pod):
        key = pod.key()
        if pod_util.is_terminal(pod) or pod.metadata.deletion_timestamp is not None:
            self.delete_pod(pod)
            return
        bound = self._bindings.get(key)
        if bound is not None and bound != pod.node_name:
            self._unbind(key, bound)
            # the OLD node's usage changed too: journal it so the snapshot
            # cache rebuilds that row as well as the new binding's
            self.mark_unconsolidated(("pod", pod, bound, True))
            bound = None
        if pod.node_name and bound is None:
            self._bindings[key] = pod.node_name
            sn = self._node_by_name(pod.node_name)
            if sn is not None:
                sn.pods[key] = pod
                sn.host_port_usage.add(pod)
                sn.volume_usage.add(pod, kube=self.store)
            if (
                pod.affinity
                and pod.affinity.pod_anti_affinity
                and pod.affinity.pod_anti_affinity.required
            ):
                self._antiaffinity_pods[key] = pod
        elif pod.node_name and bound == pod.node_name:
            sn = self._node_by_name(pod.node_name)
            if sn is not None:
                sn.pods[key] = pod  # refresh the stored object
        # EVERY non-delete pod event bumps the generation — a new binding,
        # a refreshed bound object (labels/tolerations/topology changes the
        # cached disruption snapshot tensorized from the old object), or an
        # unbound pending pod joining the counterfactual baseline. The
        # consolidation_state() contract makes this mandatory; keeping the
        # bump unconditional means a future branch cannot silently miss it.
        self.mark_unconsolidated(("pod", pod, pod.node_name or None, False))

    def delete_pod(self, pod):
        key = pod.key()
        bound = self._bindings.pop(key, None)
        if bound is not None:
            self._unbind(key, bound)
        self._antiaffinity_pods.pop(key, None)
        self.mark_unconsolidated(("pod", pod, bound, True))

    def _unbind(self, key: str, node_name: str):
        sn = self._node_by_name(node_name)
        if sn is not None:
            sn.pods.pop(key, None)
            sn.host_port_usage.remove(key)
            sn.volume_usage.remove(key)

    def _node_by_name(self, name: str):
        pid = self._node_name_to_pid.get(name)
        if pid is not None:
            return self._nodes.get(pid)
        # a claim whose node hasn't appeared yet may already carry the name
        for sn in self._nodes.values():
            if sn.name == name:
                return sn
        return None

    # -- views -----------------------------------------------------------
    def nodes(self) -> list:
        """Snapshot of all StateNodes (deep-enough copies; the scheduler and
        the disruption simulation mutate them, cluster.go Nodes())."""
        return [sn.snapshot() for sn in self._nodes.values()]

    def state_nodes(self):
        """The live (unsnapshotted) StateNodes — read-only iteration."""
        return self._nodes.values()

    def node_for(self, provider_id: str):
        return self._nodes.get(provider_id)

    def node_by_name(self, name: str):
        return self._node_by_name(name)

    def bound_node(self, pod) -> str | None:
        return self._bindings.get(pod.key())

    def pods_with_anti_affinity(self):
        for pod in self._antiaffinity_pods.values():
            node = self._node_by_name(pod.node_name)
            yield pod, (node.labels() if node is not None else {})

    # -- synced gate (cluster.go Synced:85) ------------------------------
    def synced(self) -> bool:
        for claim in self.store.list("nodeclaims"):
            if not claim.launched:
                continue  # nothing to mirror yet
            if claim.name not in self._claim_name_to_pid:
                return False
        for node in self.store.list("nodes"):
            if node.name not in self._node_name_to_pid:
                return False
        return True

    # -- nomination (cluster.go NominateNodeForPod) ----------------------
    def nominate(self, node_name: str):
        sn = self._node_by_name(node_name)
        if sn is not None:
            sn.nominate(self.clock.now())

    # -- deletion marks (cluster.go MarkForDeletion) ---------------------
    def mark_for_deletion(self, *provider_ids):
        for pid in provider_ids:
            sn = self._nodes.get(pid)
            if sn is not None:
                sn.marked_for_deletion = True
            self.mark_unconsolidated(("node", pid))
        if not provider_ids:
            self.mark_unconsolidated()

    def unmark_for_deletion(self, *provider_ids):
        for pid in provider_ids:
            sn = self._nodes.get(pid)
            if sn is not None:
                sn.marked_for_deletion = False
            self.mark_unconsolidated(("node", pid))
        if not provider_ids:
            self.mark_unconsolidated()

    # -- consolidation fence (cluster.go:310-337) ------------------------
    def mark_unconsolidated(self, delta=None) -> int:
        """Bump the state sequence. The reference uses a timestamp; a
        sequence number gives the same fencing under a fake clock.

        ``delta`` optionally journals a STRUCTURED description of what
        moved — ("node", provider_id) for any node/claim-scoped change,
        ("pod", pod, node_name|None, gone) for pod lifecycle — letting the
        disruption snapshot cache patch its tensorized view instead of
        rebuilding (ops/tensorize.py documents the delta contract). None
        journals an OPAQUE bump: consumers must treat the cached view as
        unreconstructible and rebuild. Passing no delta is therefore always
        safe, only slower."""
        self._state_seq += 1
        self._delta_journal.append((self._state_seq, delta))
        return self._state_seq

    def deltas_since(self, generation: int) -> list | None:
        """Journal entries for every bump in (generation, current], oldest
        first, or None when the journal no longer covers that range (entries
        aged out of the capped deque, or `generation` predates this process).
        A None return — like any None entry inside the list — means the
        consumer cannot patch and must rebuild."""
        if generation == self._state_seq:
            return []
        out = []
        for seq, delta in reversed(self._delta_journal):
            if seq <= generation:
                break
            out.append(delta)
        else:
            # walked off the journal without reaching `generation`: entries
            # between it and the oldest retained seq are lost
            if not self._delta_journal or self._delta_journal[0][0] != generation + 1:
                return None
        out.reverse()
        return out

    def consolidation_state(self) -> int:
        """Fence for consolidation decisions: if unchanged since the last
        fruitless consolidation round, nothing relevant moved and the
        search can be skipped (consolidation.go isConsolidated).

        This counter doubles as the GENERATION KEY of the disruption
        snapshot cache (ops/consolidate.py SnapshotCache): a tensorized
        cluster view is valid exactly as long as this value is unchanged,
        so every informer mutation that can change a scheduling answer
        must bump it."""
        return self._state_seq
