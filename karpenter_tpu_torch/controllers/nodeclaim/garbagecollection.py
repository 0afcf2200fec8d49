"""NodeClaim garbage collection: cloud ↔ claim orphan reconciliation.

Mirror of the reference's pkg/controllers/nodeclaim/garbagecollection
(controller.go:62-121): periodically List() the cloud provider and

- delete cloud instances whose NodeClaim no longer exists (leaked
  instances — e.g. the claim was deleted while the controller was down),
  respecting a grace period so freshly-launched instances whose claim
  status hasn't round-tripped yet aren't reaped;
- delete NodeClaims whose cloud instance is gone (the machine died
  underneath us), so the workload reprovisions elsewhere.

The port's copy of ``karpenter_tpu/controllers/nodeclaim/garbagecollection.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.cloudprovider.types import NodeClaimNotFoundError

# instances younger than this are never treated as leaked; mirrors the
# reference's use of nodeclaim creation recency to avoid racing Launch
GRACE_PERIOD = 5 * 60.0


class NodeClaimGarbageCollectionController:
    def __init__(self, store, cloud, clock=None, recorder=None):
        from karpenter_tpu_torch.utils.clock import Clock

        self.store = store
        self.cloud = cloud
        self.clock = clock or Clock()
        self.recorder = recorder

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        progressed = False
        claims = self.store.list("nodeclaims")
        by_pid = {c.status.provider_id: c for c in claims if c.status.provider_id}

        # one LIST serves both directions (the reference GC also works off a
        # single cloudProvider.List per resync, controller.go:62)
        cloud_claims = list(self.cloud.list())
        cloud_pids = {c.status.provider_id for c in cloud_claims}

        # leaked cloud instances: exist in the cloud, no claim references them
        for cloud_claim in cloud_claims:
            pid = cloud_claim.status.provider_id
            if pid in by_pid:
                continue
            created = cloud_claim.metadata.creation_timestamp or 0.0
            if self.clock.now() - created < GRACE_PERIOD:
                continue
            try:
                self.cloud.delete(cloud_claim)
            except NodeClaimNotFoundError:
                pass
            if self.recorder is not None:
                self.recorder.publish(
                    "GarbageCollected", f"deleted leaked instance {pid}")
            progressed = True

        # dead instances: claim is Launched+Registered but the cloud lost it
        for claim in claims:
            if not claim.status.provider_id or claim.metadata.deletion_timestamp is not None:
                continue
            if not claim.registered:
                continue  # lifecycle liveness handles pre-registration death
            if claim.status.provider_id not in cloud_pids:
                self.store.delete("nodeclaims", claim)
                if self.recorder is not None:
                    self.recorder.publish(
                        "GarbageCollected",
                        f"deleted nodeclaim {claim.name}: instance disappeared")
                progressed = True
        return progressed
