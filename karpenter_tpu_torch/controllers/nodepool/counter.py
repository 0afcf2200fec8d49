"""NodePool usage aggregation: the live capacity a pool owns.

Mirror of the reference's pkg/controllers/nodepool/counter
(controller.go:69-110). The port's copy of ``aggregate_pool_usage`` from
``karpenter_tpu/controllers/nodepool/counter.py`` (imports changed): the
provisioner reads it for a pool's remaining limits. The status-writing
controller around it comes with the controller plane (ROADMAP.md Queue 1).
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
