"""ClaimResidual: a higher-tier claim as a lower tier's scheduling target.

The cascade's residual reuse: a claim opened by an
earlier tier joins the NEXT tier's existing-node axis, so the device pack
(``ops/tensorize.py tensorize_existing`` — the same machinery real nodes
ride) can fill its remaining capacity instead of opening fresh bins.

Soundness stance (a claim is a RANGE of instance types, a node is one
concrete machine):

* the tensorized availability is the MAX allocatable over the claim's
  remaining instance types net of its accumulated requests — the FFD's
  own claim-capacity rule (models/inflight.py: "its effective capacity is
  the max over remaining types"), so the kernel packs residuals exactly
  as aggressively as the host loop would;
* the strict existing-node admission (every group-required key must be
  defined on the claim's requirement set) refuses pods whose keys the
  claim never constrained — the safe direction (they open their own bin
  or retry on the host);
* device-committed pods are NOT bound by the decode alone: ``fold()``
  re-admits each through ``InFlightNodeClaim.add`` — the exact host
  primitive, which narrows the claim's instance types and rejects any
  pod the optimistic capacity over-promised — and returns the rejects
  (the plane mops those up host-side). Topology was already committed by
  the solver's decode for these pods, so the fold swaps in a NullTopology
  to avoid double-recording.

The host pass inside ``solver.solve`` needs no adapter logic at all:
``add`` delegates straight to ``claim.add`` (bit-exact FFD semantics).

The port's copy of ``karpenter_tpu/admission/residual.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.models.scheduler import NullTopology

__all__ = ["ClaimResidual"]


class _ResidualState:
    """The state_node facade tensorize_existing reads."""

    def __init__(self, claim):
        self._claim = claim
        self.provider_id = f"claim://{claim.hostname}"

    @property
    def name(self) -> str:
        return self._claim.hostname

    @property
    def hostname(self) -> str:
        return self._claim.hostname

    @property
    def pods(self):
        return self._claim.pods  # len() = fill priority (e_npods)

    def taints(self):
        return list(self._claim.template.taints)


class ClaimResidual:
    def __init__(self, claim):
        self.claim = claim
        self.state_node = _ResidualState(claim)
        # device decode (ecommit) mutates these three in place; fold()
        # replays `pods` through claim.add and discards the rest — the
        # claim's own accounting is authoritative
        self.pods: list = []
        self.requests = dict(claim.requests)
        self.requirements = claim.requirements
        self.cached_available = self._max_alloc()
        self._host_added: list = []

    def _max_alloc(self) -> dict:
        """Per-resource MAX allocatable over the claim's remaining types —
        the FFD's effective claim capacity (models/inflight.py), compiled
        as the residual's availability; fold()'s exact re-admission is
        what keeps the optimism honest."""
        out: dict = {}
        for it in self.claim.instance_types:
            for r, v in it.allocatable().items():
                if v > out.get(r, 0.0):
                    out[r] = v
        return out

    # -- host-pass interface (Scheduler._add tries existing nodes first) --
    @property
    def scheduled_pods(self) -> list:
        # the plane folds device commits into the claim and drops the
        # residual before results surface; never report pods twice
        return []

    def add(self, pod):
        err = self.claim.add(pod)
        if err is None:
            self._host_added.append(pod)
        return err

    # -- decode-commit fold ----------------------------------------------
    def fold(self, originals: dict | None = None) -> list:
        """Re-admit device-committed pods through the claim's exact add
        (NullTopology — the solver's decode already recorded topology for
        them); remap host-added clones to the caller's originals. Returns
        the pods the exact check refused."""
        fails = []
        if self.pods:
            saved = self.claim.topology
            self.claim.topology = NullTopology()
            try:
                for p in self.pods:
                    if self.claim.add(p) is not None:
                        fails.append(p)
            finally:
                self.claim.topology = saved
            self.pods = []
        if originals and (self._host_added or self.claim.pods):
            self.claim.pods = [
                originals.get(p.uid, p) for p in self.claim.pods
            ]
        self._host_added = []
        return fails
