"""StateNode: the merged NodeClaim + Node view.

The port's copy of ``karpenter_tpu/state/statenode.py`` (imports changed).

Behavioral mirror of the reference's pkg/controllers/state/statenode.go: a
single logical machine may be represented by a NodeClaim (in flight), a Node
(registered), or both. The scheduler consumes StateNodes as existing
capacity; the disruption controller consumes them as candidates. Key
semantics: `registered`/`initialized` (statenode.go:297-314), `available()`
= allocatable − pod requests (:350), taints drawn from the claim until the
node initializes, `nominate` with a TTL window (:392-398, :432), and
`validate_disruptable` (do-not-disrupt annotation + nodepool resolvability,
:174).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.scheduling.hostports import HostPortUsage
from karpenter_tpu_torch.scheduling.taints import KNOWN_EPHEMERAL_TAINTS
from karpenter_tpu_torch.scheduling.volumes import VolumeUsage
from karpenter_tpu_torch.utils import resources as resutil

# How long a nomination reserves in-flight capacity before the pod must have
# bound (the reference derives this from 2× the batch max duration,
# cluster.go nominationWindow).
NOMINATION_WINDOW = 20.0


class StateNode:
    def __init__(self, provider_id: str = ""):
        self.provider_id = provider_id
        self.node = None  # api.objects.Node | None
        self.node_claim = None  # api.nodeclaim.NodeClaim | None
        # pod bookkeeping (maintained by Cluster)
        self.pods: dict = {}  # pod key -> Pod (bound, non-terminal)
        self.host_port_usage = HostPortUsage()
        self.volume_usage = VolumeUsage()
        # disruption bookkeeping
        self.marked_for_deletion: bool = False
        self.nominated_until: float = 0.0
        # spot interruption notice: the provider's reclaim deadline (clock
        # seconds) or None. Set by Cluster.note_interruption when the
        # disruption controller pulls a notice; consumed by the
        # InterruptionDrain method (proactive drain-and-replace)
        self.interruption_deadline: float | None = None

    # -- identity --------------------------------------------------------
    @property
    def name(self) -> str:
        if self.node is not None:
            return self.node.name
        if self.node_claim is not None:
            return self.node_claim.status.node_name or self.node_claim.name
        return ""

    @property
    def hostname(self) -> str:
        if self.node is not None:
            return self.node.labels.get(wk.HOSTNAME_LABEL, self.node.name)
        return self.name

    def labels(self) -> dict:
        if self.node is not None:
            return self.node.labels
        if self.node_claim is not None:
            return self.node_claim.metadata.labels
        return {}

    def annotations(self) -> dict:
        out = {}
        if self.node_claim is not None:
            out.update(self.node_claim.metadata.annotations)
        if self.node is not None:
            out.update(self.node.metadata.annotations)
        return out

    @property
    def nodepool_name(self) -> str:
        return self.labels().get(wk.NODEPOOL_LABEL, "")

    def managed(self) -> bool:
        """Owned by a NodeClaim (vs. a bring-your-own node)."""
        return self.node_claim is not None or wk.NODEPOOL_LABEL in self.labels()

    # -- lifecycle gates (statenode.go:297-314) --------------------------
    def registered(self) -> bool:
        if self.node_claim is not None:
            return self.node_claim.registered
        return self.node is not None and self.node.labels.get(wk.NODE_REGISTERED_LABEL) == "true"

    def initialized(self) -> bool:
        if self.node_claim is not None:
            return self.node_claim.initialized
        return self.node is not None and self.node.labels.get(wk.NODE_INITIALIZED_LABEL) == "true"

    def deleting(self) -> bool:
        if self.node is not None and self.node.metadata.deletion_timestamp is not None:
            return True
        if self.node_claim is not None and self.node_claim.metadata.deletion_timestamp is not None:
            return True
        return False

    # -- capacity (statenode.go:340-360) ---------------------------------
    def capacity(self) -> dict:
        # trust the claim's view until the node has initialized: kubelet may
        # not have registered extended resources yet
        if self.node_claim is not None and not self.initialized():
            return dict(self.node_claim.status.capacity or {})
        if self.node is not None:
            return dict(self.node.capacity)
        if self.node_claim is not None:
            return dict(self.node_claim.status.capacity or {})
        return {}

    def allocatable(self) -> dict:
        if self.node_claim is not None and not self.initialized():
            return dict(self.node_claim.status.allocatable or {})
        if self.node is not None:
            return dict(self.node.allocatable)
        if self.node_claim is not None:
            return dict(self.node_claim.status.allocatable or {})
        return {}

    def pod_requests(self) -> dict:
        total: dict = {}
        for pod in self.pods.values():
            total = resutil.merge(total, pod.effective_requests())
        return total

    def daemonset_requests(self) -> dict:
        total: dict = {}
        for pod in self.pods.values():
            if pod.owned_by_daemonset():
                total = resutil.merge(total, pod.effective_requests())
        return total

    def available(self) -> dict:
        """Allocatable minus everything already placed (statenode.go:350)."""
        return resutil.subtract(self.allocatable(), self.pod_requests())

    # -- taints (statenode.go Taints) ------------------------------------
    def taints(self) -> list:
        if not self.initialized() and self.node_claim is not None:
            return list(self.node_claim.spec.taints)
        if self.node is not None:
            ephemeral = {t.key for t in KNOWN_EPHEMERAL_TAINTS}
            startup = (
                {t.key for t in self.node_claim.spec.startup_taints}
                if self.node_claim is not None
                else set()
            )
            return [t for t in self.node.taints if t.key not in ephemeral and t.key not in startup]
        return []

    # -- interruption (spot resilience) ----------------------------------
    def interruption_pending(self) -> bool:
        """A live interruption notice awaits action on this node: the
        deadline is set and the node is not already leaving. The ONE
        predicate shared by the disruption controller's round gate, the
        InterruptionDrain method's prewarm hint, and its candidate
        discovery — they must never disagree on what counts as noticed."""
        return (
            self.interruption_deadline is not None
            and not self.marked_for_deletion
            and not self.deleting()
        )

    # -- nomination (statenode.go:392-398) -------------------------------
    def nominate(self, now: float):
        self.nominated_until = now + NOMINATION_WINDOW

    def nominated(self, now: float) -> bool:
        return self.nominated_until > now

    # -- disruption gate (statenode.go ValidateDisruptable:174) ----------
    def validate_disruptable(self, pdb_limits=None) -> str | None:
        if self.annotations().get(wk.DO_NOT_DISRUPT_ANNOTATION) == "true":
            return "disruption is blocked through the do-not-disrupt annotation"
        if not self.registered() or not self.initialized():
            return "node is not initialized"
        if not self.nodepool_name:
            return "node does not belong to a nodepool"
        for pod in self.pods.values():
            if pod.metadata.annotations.get(wk.DO_NOT_DISRUPT_ANNOTATION) == "true":
                return f"pod {pod.key()} has the do-not-disrupt annotation"
            if pdb_limits is not None:
                blocking = pdb_limits.can_evict(pod)
                if blocking is not None:
                    return f"pdb {blocking} prevents pod evictions"
        return None

    def reschedulable_pods(self) -> list:
        from karpenter_tpu_torch.utils import pod as pod_util

        return [p for p in self.pods.values() if pod_util.is_reschedulable(p)]

    def snapshot(self) -> "StateNode":
        """Deep-enough copy for a scheduling simulation: the scheduler's
        ExistingNode wrapper mutates usage trackers, never the originals
        (the reference deep-copies StateNodes into each solve,
        cluster.go Nodes())."""
        out = StateNode(self.provider_id)
        out.node = self.node
        out.node_claim = self.node_claim
        out.pods = dict(self.pods)
        out.host_port_usage = self.host_port_usage.copy()
        out.volume_usage = self.volume_usage.copy()
        out.marked_for_deletion = self.marked_for_deletion
        out.nominated_until = self.nominated_until
        out.interruption_deadline = self.interruption_deadline
        return out

    def __repr__(self):
        return (
            f"StateNode({self.name or self.provider_id}, claim={self.node_claim is not None}, "
            f"node={self.node is not None}, pods={len(self.pods)})"
        )
