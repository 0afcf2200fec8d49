"""NodePool hash controller: stamps the drift-detection basis.

Mirror of the reference's pkg/controllers/nodepool/hash/controller.go:49-106:
the static-field hash of each NodePool spec is written to its annotations;
NodeClaims stamped from the pool carry the same annotation, and the drift
condition controller compares the two.

The port's copy of ``karpenter_tpu/controllers/nodepool/hash.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk

HASH_VERSION = wk.NODEPOOL_HASH_VERSION


class NodePoolHashController:
    def __init__(self, store):
        self.store = store

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        progressed = False
        for np in self.store.list("nodepools"):
            h = np.static_hash()
            ann = np.metadata.annotations
            if ann.get(wk.NODEPOOL_HASH_ANNOTATION) != h or ann.get(
                wk.NODEPOOL_HASH_VERSION_ANNOTATION
            ) != HASH_VERSION:
                if ann.get(wk.NODEPOOL_HASH_VERSION_ANNOTATION) != HASH_VERSION:
                    # hash-version migration: re-stamp owned claims so a
                    # version bump alone never reads as drift
                    # (hash/controller.go updateNodeClaimHash :89-106)
                    from karpenter_tpu_torch.api.nodeclaim import COND_DRIFTED

                    for claim in self.store.list("nodeclaims"):
                        if claim.metadata.labels.get(wk.NODEPOOL_LABEL) != np.name:
                            continue
                        if (
                            claim.metadata.annotations.get(
                                wk.NODEPOOL_HASH_VERSION_ANNOTATION
                            )
                            == HASH_VERSION
                        ):
                            continue
                        # an already-drifted claim keeps its stale hash: the
                        # old hashing scheme is gone, so its drift verdict
                        # cannot be re-derived and must stand
                        if not claim.is_true(COND_DRIFTED):
                            claim.metadata.annotations[wk.NODEPOOL_HASH_ANNOTATION] = h
                        claim.metadata.annotations[
                            wk.NODEPOOL_HASH_VERSION_ANNOTATION
                        ] = HASH_VERSION
                        self.store.update("nodeclaims", claim)
                ann[wk.NODEPOOL_HASH_ANNOTATION] = h
                ann[wk.NODEPOOL_HASH_VERSION_ANNOTATION] = HASH_VERSION
                self.store.update("nodepools", np)
                progressed = True
        return progressed
