"""Lease garbage collection: delete orphaned kubelet heartbeat leases.

Mirror of the reference's pkg/controllers/leasegarbagecollection
(controller.go:48): kubelets heartbeat through Lease objects in the
kube-node-lease namespace, owned by their Node. When a node is deleted the
kubelet can't clean its lease up; this controller deletes leases whose
owning Node no longer exists.

The port's copy of ``karpenter_tpu/controllers/node/leasegc.py`` (imports changed).
"""

from __future__ import annotations

NODE_LEASE_NAMESPACE = "kube-node-lease"


class LeaseGarbageCollectionController:
    def __init__(self, store, recorder=None):
        self.store = store
        self.recorder = recorder

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        progressed = False
        nodes = {n.metadata.name for n in self.store.list("nodes")}
        for lease in list(self.store.list("leases", namespace=NODE_LEASE_NAMESPACE)):
            owners = [o for o in lease.metadata.owner_references if o.get("kind") == "Node"]
            if not owners:
                continue  # not a kubelet node lease
            if any(o.get("name") in nodes for o in owners):
                continue
            self.store.delete("leases", lease)
            if self.recorder is not None:
                self.recorder.publish(
                    "GarbageCollected", f"deleted orphaned lease {lease.metadata.name}")
            progressed = True
        return progressed
