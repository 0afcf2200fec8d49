"""NodeClaim lifecycle: Launch → Register → Initialize (+ liveness,
termination finalizer).

Mirror of the reference's pkg/controllers/nodeclaim/lifecycle
(controller.go:78-126, launch.go:45, registration.go:43,
initialization.go:49, liveness.go:40-58) and nodeclaim/termination
(controller.go:67-140): claims are launched through the CloudProvider,
joined to their Node by providerID, initialized once the node is ready with
startup taints cleared and requested resources registered, deleted and
retried if registration doesn't happen within the liveness TTL, and on
deletion the finalizer tears down the cloud instance then the node.

The port's copy of ``karpenter_tpu/controllers/nodeclaim/lifecycle.py``
(imports changed): a launch and a registration each record a fleet-ledger
event (obs/timeline.py).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.nodeclaim import (
    COND_INITIALIZED,
    COND_LAUNCHED,
    COND_REGISTERED,
)
from karpenter_tpu_torch.cloudprovider.types import InsufficientCapacityError, NodeClaimNotFoundError
from karpenter_tpu_torch.obs import timeline
from karpenter_tpu_torch.operator import metrics as m
from karpenter_tpu_torch.scheduling.taints import KNOWN_EPHEMERAL_TAINTS

REGISTRATION_TTL = 15 * 60.0  # liveness.go:40


class NodeClaimLifecycleController:
    def __init__(self, store, cloud, clock=None, recorder=None, registry=None):
        from karpenter_tpu_torch.utils.clock import Clock

        self.store = store
        self.cloud = cloud
        self.clock = clock or Clock()
        self.recorder = recorder
        self.registry = registry or m.REGISTRY

    def _count(self, family: str, claim):
        """Machine-lifecycle counter labelled by nodepool
        (pkg/metrics/metrics.go:30)."""
        self.registry.counter(family).inc(
            nodepool=claim.metadata.labels.get(wk.NODEPOOL_LABEL, ""))

    def on_event(self, event):
        pass  # reconciled via poll() sweeps in the hermetic runtime

    def poll(self) -> bool:
        claims = list(self.store.list("nodeclaims"))
        if not claims:
            return False
        # one providerID→node index per poll: `_node_for` per claim was a
        # full node scan, O(claims × nodes) per poll — it dominated the
        # post-command wave at fleet scale, where every retired claim's
        # finalizer walks the lookup several times. A node _launch creates
        # mid-poll belongs to the claim that just launched (which already
        # returned for this poll), so the index cannot serve a stale miss
        # to any OTHER claim; deletion timestamps are visible through the
        # shared object identity.
        self._nodes_by_pid = {}
        for node in self.store.list("nodes"):
            if node.provider_id:
                self._nodes_by_pid.setdefault(node.provider_id, node)
        try:
            progressed = False
            for claim in claims:
                if self.reconcile(claim):
                    progressed = True
            return progressed
        finally:
            self._nodes_by_pid = None
            self._catalog = None

    def reconcile(self, claim) -> bool:
        if claim.metadata.deletion_timestamp is not None:
            return self._finalize(claim)
        if not claim.is_true(COND_LAUNCHED):
            return self._launch(claim)
        changed = False
        if not claim.is_true(COND_REGISTERED):
            changed = self._register(claim)
            if not claim.is_true(COND_REGISTERED):
                changed = self._liveness(claim) or changed
                return changed
        if not claim.is_true(COND_INITIALIZED):
            changed = self._initialize(claim) or changed
        return changed

    # -- launch (lifecycle/launch.go:45) ---------------------------------
    def _launch(self, claim) -> bool:
        try:
            launched = self.cloud.create(claim)
        except InsufficientCapacityError as e:
            # terminal: delete so scheduling retries elsewhere (launch.go:80)
            if self.recorder is not None:
                self.recorder.publish("InsufficientCapacity", str(e))
            claim.metadata.finalizers = []
            self.store.delete("nodeclaims", claim)
            return True
        claim.status.provider_id = launched.status.provider_id
        claim.status.node_name = launched.status.node_name
        claim.status.capacity = launched.status.capacity
        claim.status.allocatable = launched.status.allocatable
        claim.metadata.labels = dict(launched.metadata.labels)
        claim.set_condition(COND_LAUNCHED, now=self.clock.now())
        self.store.update("nodeclaims", claim)
        self._count(m.NODECLAIMS_LAUNCHED, claim)
        timeline.note_launch(
            claim.metadata.name, node=claim.status.node_name,
            price=self._launch_price(claim.metadata.labels),
            registry=self.registry,
            nodepool=claim.metadata.labels.get(wk.NODEPOOL_LABEL, ""))
        return True

    # -- registration (lifecycle/registration.go:43) ---------------------
    def _register(self, claim) -> bool:
        node = self._node_for(claim)
        if node is None:
            return False
        # sync labels/taints from the claim onto the node; drop the
        # unregistered NoExecute taint
        node.metadata.labels.update(claim.metadata.labels)
        node.metadata.labels[wk.NODE_REGISTERED_LABEL] = "true"
        node.taints = [t for t in node.taints if t.key != wk.UNREGISTERED_TAINT_KEY]
        # managed nodes drain through the termination finalizer
        # (registration.go syncs it onto the node)
        if wk.TERMINATION_FINALIZER not in node.metadata.finalizers:
            node.metadata.finalizers.append(wk.TERMINATION_FINALIZER)
        self.store.update("nodes", node)
        claim.status.node_name = node.name
        claim.set_condition(COND_REGISTERED, now=self.clock.now())
        self.store.update("nodeclaims", claim)
        self._count(m.NODECLAIMS_REGISTERED, claim)
        self._count(m.NODES_CREATED, claim)  # node joined the cluster
        timeline.record_event("register", node.name,
                              claim=claim.metadata.name,
                              registry=self.registry)
        return True

    # -- initialization (lifecycle/initialization.go:49) -----------------
    def _initialize(self, claim) -> bool:
        node = self._node_for(claim)
        if node is None or not node.ready:
            return False
        ephemeral = {t.key for t in KNOWN_EPHEMERAL_TAINTS}
        startup_keys = {t.key for t in claim.spec.startup_taints}
        if any(t.key in ephemeral or t.key in startup_keys for t in node.taints):
            return False
        # requested resources must be registered on the node
        for r, v in (claim.status.allocatable or {}).items():
            if node.allocatable.get(r, 0.0) <= 0 and v > 0:
                return False
        node.metadata.labels[wk.NODE_INITIALIZED_LABEL] = "true"
        self.store.update("nodes", node)
        claim.set_condition(COND_INITIALIZED, now=self.clock.now())
        self.store.update("nodeclaims", claim)
        self._count(m.NODECLAIMS_INITIALIZED, claim)
        return True

    # -- liveness (lifecycle/liveness.go:40) -----------------------------
    def _liveness(self, claim) -> bool:
        age = self.clock.now() - claim.metadata.creation_timestamp
        if age > REGISTRATION_TTL:
            self.store.delete("nodeclaims", claim)
            return True
        return False

    # -- termination finalizer (nodeclaim/termination/controller.go:67) --
    def _finalize(self, claim) -> bool:
        if wk.TERMINATION_FINALIZER not in claim.metadata.finalizers:
            return False
        node = self._node_for(claim)
        if node is not None:
            if node.metadata.deletion_timestamp is None:
                # start the graceful drain; the node.termination controller
                # evicts pods and releases the node's finalizer
                self.store.delete("nodes", node)
                return True
            return False  # drain in progress: wait for the node to go away
        if claim.status.provider_id:
            try:
                self.cloud.delete(claim)
            except NodeClaimNotFoundError:
                pass
        claim.metadata.finalizers = [
            f for f in claim.metadata.finalizers if f != wk.TERMINATION_FINALIZER
        ]
        self.store.update("nodeclaims", claim)
        self._count(m.NODECLAIMS_TERMINATED, claim)
        if claim.metadata.deletion_timestamp is not None:
            # delete-request → instance-gone latency (the reference's
            # NodeClaimTerminationDuration summary)
            self.registry.histogram(
                m.NODECLAIM_TERMINATION_DURATION,
                "seconds from nodeclaim deletion to finalizer release",
            ).observe(self.clock.now() - claim.metadata.deletion_timestamp,
                      nodepool=claim.metadata.labels.get(wk.NODEPOOL_LABEL, ""))
        return True

    _nodes_by_pid = None  # per-poll providerID index (see poll)
    _catalog = None  # per-poll CatalogView memo (see poll)

    def _launch_price(self, labels) -> float:
        """Effective hourly price of the launched offering — the fleet
        ledger's launch-rate input (obs/timeline.py). The CatalogView is
        memoized per poll like ``_nodes_by_pid``; a direct ``reconcile``
        call pays one transient view."""
        from karpenter_tpu_torch.cloudprovider.types import CatalogView, effective_price

        view = self._catalog
        if view is None:
            view = CatalogView(self.store.list("nodepools"), self.cloud)
            if self._nodes_by_pid is not None:  # inside a poll: memoize
                self._catalog = view
        off = view.offering(labels)
        return float(effective_price(off)) if off is not None else 0.0

    def _node_for(self, claim):
        if not claim.status.provider_id:
            return None
        if self._nodes_by_pid is not None:
            return self._nodes_by_pid.get(claim.status.provider_id)
        for node in self.store.list("nodes"):
            if node.provider_id == claim.status.provider_id:
                return node
        return None
