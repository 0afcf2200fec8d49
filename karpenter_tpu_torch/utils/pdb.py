"""PodDisruptionBudget limits: can a pod be evicted right now?

Mirror of the reference's utils/pdb.Limits (limits.go:35-94): collect all
PDBs, map each pod to the PDBs selecting it, and report the first PDB that
currently allows zero disruptions. The disruption controller uses this to
exclude candidates whose drain would block (types.go:64).

The port's copy of ``karpenter_tpu/utils/pdb.py`` (imports changed).
"""

from __future__ import annotations


class PdbLimits:
    def __init__(self, store):
        self._pdbs = []  # [(pdb, disruptions_allowed)]
        for pdb in store.list("pdbs"):
            self._pdbs.append((pdb, store._disruptions_allowed(pdb)))

    def can_evict(self, pod) -> str | None:
        """Returns the name of a blocking PDB, or None if evictable."""
        for pdb, allowed in self._pdbs:
            if pdb.metadata.namespace != pod.metadata.namespace:
                continue
            if pdb.selector is not None and pdb.selector.matches(pod.metadata.labels):
                if allowed <= 0:
                    return pdb.metadata.name
        return None
