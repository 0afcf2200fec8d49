"""NodePool counter: aggregate owned-node resources into status.

Mirror of the reference's pkg/controllers/nodepool/counter
(controller.go:69-110): sums the capacity of every node (and launched-but-
unregistered nodeclaim) owned by the pool into NodePool.status.resources,
including a synthetic "nodes" count. The provisioner reads the live
aggregate for a pool's remaining limits.

The port's copy of ``karpenter_tpu/controllers/nodepool/counter.py``
(imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.utils import resources as resutil


def aggregate_pool_usage(store, np) -> dict:
    """Capacity owned by the pool right now: registered nodes plus
    launched-but-unregistered claims (merged by providerID the way cluster
    state does), with a synthetic "nodes" count."""
    total: dict = {"nodes": 0.0}
    counted_pids = set()
    for node in store.list("nodes"):
        if node.labels.get(wk.NODEPOOL_LABEL) != np.name:
            continue
        total = resutil.merge(total, node.capacity)
        total["nodes"] += 1
        counted_pids.add(node.provider_id)
    for claim in store.list("nodeclaims"):
        if claim.metadata.labels.get(wk.NODEPOOL_LABEL) != np.name:
            continue
        if claim.status.provider_id in counted_pids:
            continue
        if not claim.status.capacity:
            continue
        total = resutil.merge(total, claim.status.capacity)
        total["nodes"] += 1
    return total


class NodePoolCounterController:
    def __init__(self, store):
        self.store = store

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        progressed = False
        for np in list(self.store.list("nodepools")):
            total = aggregate_pool_usage(self.store, np)
            if total != np.status.resources:
                np.status.resources = total
                self.store.update("nodepools", np)
                progressed = True
        return progressed
