"""NodeClaim disruption-condition controller.

Mirror of the reference's pkg/controllers/nodeclaim/disruption
(controller.go:70): maintains the status conditions the disruption
controller consumes —

- Drifted (drift.go:46-141): static-field hash mismatch against the owning
  NodePool's annotation, requirement drift (node no longer satisfies the
  pool's requirements), or the cloud provider reporting drift.
- Empty (emptiness.go:45): no reschedulable pods on the node, only under
  the WhenEmpty consolidation policy.
- Expired (expiration.go:38): claim older than the pool's expireAfter.

Conditions only ever flip for initialized claims; deleting claims are
skipped.

The port's copy of ``karpenter_tpu/controllers/nodeclaim/disruption.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.nodeclaim import COND_DRIFTED, COND_EMPTY, COND_EXPIRED
from karpenter_tpu_torch.api.nodepool import CONSOLIDATION_WHEN_EMPTY
from karpenter_tpu_torch.scheduling import label_requirements, node_selector_requirements


class NodeClaimDisruptionController:
    def __init__(self, store, cloud, cluster, clock=None, registry=None):
        from karpenter_tpu_torch.operator import metrics as _m
        from karpenter_tpu_torch.utils.clock import Clock

        self.store = store
        self.cloud = cloud
        self.cluster = cluster
        self.clock = clock or Clock()
        self.registry = registry or _m.REGISTRY
        self._disrupted = self.registry.counter(
            _m.NODECLAIMS_DISRUPTED, "nodeclaims disrupted by reason")

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        progressed = False
        pools = {np.name: np for np in self.store.list("nodepools")}
        for claim in list(self.store.list("nodeclaims")):
            if claim.metadata.deletion_timestamp is not None:
                continue
            np = pools.get(claim.metadata.labels.get(wk.NODEPOOL_LABEL))
            if np is None:
                continue
            if self._reconcile_drift(claim, np):
                progressed = True
            if self._reconcile_empty(claim, np):
                progressed = True
            if self._reconcile_expired(claim, np):
                progressed = True
        return progressed

    # -- drift (nodeclaim/disruption/drift.go:46) ------------------------
    def _reconcile_drift(self, claim, np) -> bool:
        if not claim.launched:
            return False
        reason = self._drift_reason(claim, np)
        if reason and not claim.is_true(COND_DRIFTED):
            claim.set_condition(COND_DRIFTED, reason=reason, now=self.clock.now())
            self.store.update("nodeclaims", claim)
            return True
        if not reason and claim.get_condition(COND_DRIFTED) is not None:
            claim.clear_condition(COND_DRIFTED)
            self.store.update("nodeclaims", claim)
            return True
        return False

    def _drift_reason(self, claim, np) -> str | None:
        # static-field hash (drift.go areStaticFieldsDrifted)
        pool_hash = np.metadata.annotations.get(wk.NODEPOOL_HASH_ANNOTATION)
        pool_ver = np.metadata.annotations.get(wk.NODEPOOL_HASH_VERSION_ANNOTATION)
        claim_hash = claim.metadata.annotations.get(wk.NODEPOOL_HASH_ANNOTATION)
        claim_ver = claim.metadata.annotations.get(wk.NODEPOOL_HASH_VERSION_ANNOTATION)
        if pool_hash and claim_hash and pool_ver == claim_ver and pool_hash != claim_hash:
            return "NodePoolDrifted"
        # requirement drift (drift.go areRequirementsDrifted): the pool's
        # requirements must still admit the claim's labels
        pool_reqs = node_selector_requirements(np.spec.template.requirements)
        claim_labels = label_requirements(claim.metadata.labels)
        for key, req in pool_reqs.items():
            have = claim_labels.get_req(key)
            if len(req.intersection(have)) == 0:
                return "RequirementsDrifted"
        # cloud-provider drift (e.g. AMI drift in real providers)
        cloud_reason = self.cloud.is_drifted(claim)
        if cloud_reason:
            return cloud_reason
        return None

    # -- emptiness (nodeclaim/disruption/emptiness.go:45) ----------------
    def _reconcile_empty(self, claim, np) -> bool:
        if np.spec.disruption.consolidation_policy != CONSOLIDATION_WHEN_EMPTY:
            if claim.get_condition(COND_EMPTY) is not None:
                claim.clear_condition(COND_EMPTY)
                self.store.update("nodeclaims", claim)
                return True
            return False
        if not claim.initialized:
            return False
        sn = self.cluster.node_for(claim.status.provider_id)
        if sn is None:
            return False
        empty = not sn.reschedulable_pods()
        if empty and not claim.is_true(COND_EMPTY):
            claim.set_condition(COND_EMPTY, now=self.clock.now())
            self.store.update("nodeclaims", claim)
            return True
        if not empty and claim.get_condition(COND_EMPTY) is not None:
            claim.clear_condition(COND_EMPTY)
            self.store.update("nodeclaims", claim)
            return True
        return False

    # -- expiration (nodeclaim/disruption/expiration.go:38-58) -----------
    def _reconcile_expired(self, claim, np) -> bool:
        expire_after = np.spec.disruption.expire_after
        if not expire_after:
            if claim.get_condition(COND_EXPIRED) is not None:
                claim.clear_condition(COND_EXPIRED)
                self.store.update("nodeclaims", claim)
                return True
            return False
        age = self.clock.now() - claim.metadata.creation_timestamp
        if age < expire_after:
            return False
        if not claim.is_true(COND_EXPIRED):
            claim.set_condition(COND_EXPIRED, now=self.clock.now())
            self.store.update("nodeclaims", claim)
        # the reference FORCEFULLY expires: the claim is deleted outright —
        # no simulation, no budget, no pre-provisioned replacement
        # (expiration.go:52 "we can forcefully expire the nodeclaim");
        # the termination finalizer ring still drains the node gracefully,
        # and displaced pods re-provision through the normal pending path.
        # (poll() already skips terminating claims, so delete runs once.)
        self.store.delete("nodeclaims", claim)
        self._disrupted.inc(
            type="expiration",
            nodepool=claim.metadata.labels.get(wk.NODEPOOL_LABEL, ""))
        return True
