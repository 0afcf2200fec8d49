"""NodeClaim consistency: invariant checks between a claim and its node.

Mirror of the reference's pkg/controllers/nodeclaim/consistency
(controller.go:78-143): once a claim is initialized, verify the machine the
cloud delivered matches what was promised — the node advertises at least
the claim's requested resources (NodeShape check) and carries the labels
the claim's requirements demanded. Violations emit FailedConsistencyCheck
events and set the ConsistentStateFound condition False; the check is a
canary for provider bugs, not an enforcement path.

The port's copy of ``karpenter_tpu/controllers/nodeclaim/consistency.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.api.nodeclaim import COND_CONSISTENT
from karpenter_tpu_torch.scheduling import label_requirements, node_selector_requirements


class NodeClaimConsistencyController:
    def __init__(self, store, clock=None, recorder=None):
        from karpenter_tpu_torch.utils.clock import Clock

        self.store = store
        self.clock = clock or Clock()
        self.recorder = recorder
        # event-driven re-check set: the invariant between a claim and its
        # node only moves when one of THEM moves, so re-deriving every
        # claim's requirement objects each poll is O(claims × labels) of
        # pure waste on an idle fleet. A claim is (re)checked when its
        # condition is missing or when a node/claim event names it.
        self._dirty: set = set()

    def on_event(self, event):
        obj = event.obj
        if event.kind == "nodes":
            if obj.provider_id:
                self._dirty.add(obj.provider_id)
            self._dirty.add(obj.name)
        elif event.kind == "nodeclaims":
            self._dirty.add(obj.name)
            if obj.status.provider_id:
                self._dirty.add(obj.status.provider_id)

    def poll(self) -> bool:
        progressed = False
        limits = None  # built once per poll, only if something terminates
        # provider-id index built once per poll: the per-claim linear node
        # scan was O(claims × nodes) and showed up in fleet-scale benches
        self._nodes_by_pid = {
            n.provider_id: n for n in self.store.list("nodes") if n.provider_id
        }
        self._pods_by_node = None  # built lazily, only if something terminates
        dirty, self._dirty = self._dirty, set()
        for claim in list(self.store.list("nodeclaims")):
            if claim.metadata.deletion_timestamp is not None:
                # stuck-termination canary (consistency/termination.go:46):
                # a terminating claim whose drain a PDB is blocking gets a
                # visible reason instead of hanging silently. Pure
                # observability: never counts as progress (the recorder
                # dedupes repeats), or a stuck drain would spin the ring.
                if limits is None:
                    from karpenter_tpu_torch.utils.pdb import PdbLimits

                    limits = PdbLimits(self.store)
                self._report_stuck_termination(claim, limits)
                continue
            if not claim.initialized:
                continue
            if (
                claim.get_condition(COND_CONSISTENT) is not None
                and claim.name not in dirty
                and claim.status.provider_id not in dirty
            ):
                continue  # nothing about this pair moved since the last check
            node = self._node_for(claim)
            if node is None:
                continue
            failures = self._check(claim, node)
            want = "False" if failures else "True"
            cond = claim.get_condition(COND_CONSISTENT)
            if cond is None or cond.status != want:
                claim.set_condition(
                    COND_CONSISTENT, status=want,
                    reason="ConsistencyCheckFailed" if failures else "ConsistentStateFound",
                    message="; ".join(failures), now=self.clock.now())
                self.store.update("nodeclaims", claim)
                if failures and self.recorder is not None:
                    self.recorder.publish(
                        "FailedConsistencyCheck", "; ".join(failures), obj=claim)
                progressed = True
        return progressed

    def _report_stuck_termination(self, claim, limits):
        from karpenter_tpu_torch.utils import pod as pod_util

        node = self._node_for(claim)
        if node is None or self.recorder is None:
            return
        if self._pods_by_node is None:
            # one pass over the store instead of one per terminating claim
            # (a consolidation wave terminates hundreds at once)
            self._pods_by_node = {}
            for p in self.store.list("pods"):
                self._pods_by_node.setdefault(p.node_name, []).append(p)
        for pod in self._pods_by_node.get(node.name, ()):
            if pod.metadata.deletion_timestamp:
                continue
            # mirror the drain's own filter (node/termination.py): pods the
            # terminator never evicts cannot block it, so their PDBs must
            # not trigger a false canary
            if pod.owned_by_daemonset() or pod_util.is_owned_by_node(pod):
                continue
            if not pod_util.is_evictable(pod):
                continue
            blocking = limits.can_evict(pod)
            if blocking is not None:
                # emit-once semantics ride the recorder's dedupe TTL
                self.recorder.publish(
                    "FailedConsistencyCheck",
                    f'can\'t drain node, PDB "{pod.namespace}/{blocking}" '
                    "is blocking evictions",
                    obj=claim,
                )
                return

    def _check(self, claim, node) -> list[str]:
        failures = []
        # NodeShape: the node must register at least the allocatable the
        # claim's instance type promised (consistency/nodeshape.go)
        for r, want in (claim.status.allocatable or {}).items():
            got = node.allocatable.get(r, 0.0)
            if got < want * 0.9:  # kubelet reserves a little; 10% slack
                failures.append(
                    f"node {node.name} allocatable {r}={got} below claim's {want}")
        # node labels must satisfy the claim's requirements
        # two-way overlap only: an Exists/complement requirement stamps no
        # node label by design (Requirements.labels() skips unbounded sets),
        # so a one-way Compatible check would false-positive on it forever
        reqs = node_selector_requirements(claim.spec.requirements)
        err = label_requirements(node.labels).intersects(reqs)
        if err is not None:
            failures.append(f"node {node.name} labels conflict with claim requirements: {err}")
        return failures

    def _node_for(self, claim):
        if not claim.status.provider_id:
            return None
        return self._nodes_by_pid.get(claim.status.provider_id)
