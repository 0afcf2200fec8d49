"""Disruption candidates and commands.

Mirror of the reference's pkg/controllers/disruption/types.go: a `Candidate`
is a disruptable StateNode annotated with its pool, instance type, offering
price, reschedulable pods, and disruption cost (types.go:53-101); a
`Command` is a set of candidates plus the replacement claims that the
simulation produced, with the resulting action (types.go:103-169).

The port's copy of ``karpenter_tpu/controllers/disruption/types.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.cloudprovider.types import effective_price
from karpenter_tpu_torch.utils.disruption import disruption_cost


class Candidate:
    def __init__(self, state_node, node_pool, instance_type, clock):
        from karpenter_tpu_torch.cloudprovider.types import risk_lambda

        # λ snapshotted at discovery: candidates live one round, and the
        # price property is read across thousands of candidates per round
        # — one env parse per candidate, not one per access
        self._risk_lambda = risk_lambda()
        self.state_node = state_node
        self.node_pool = node_pool
        self.instance_type = instance_type
        labels = state_node.labels()
        self.zone = labels.get(wk.TOPOLOGY_ZONE_LABEL, "")
        self.capacity_type = labels.get(wk.CAPACITY_TYPE_LABEL, wk.CAPACITY_TYPE_ON_DEMAND)
        self.reschedulable_pods = state_node.reschedulable_pods()
        self.disruption_cost = disruption_cost(
            self.reschedulable_pods,
            state_node=state_node,
            expire_after=node_pool.spec.disruption.expire_after,
            now=clock.now(),
        )

    @property
    def name(self) -> str:
        return self.state_node.name

    @property
    def provider_id(self) -> str:
        return self.state_node.provider_id

    @property
    def price(self) -> float:
        """Current EFFECTIVE offering price for this node's (zone,
        capacity type): risk-discounted per cloudprovider/types.
        effective_price, so a risky spot node reads as more expensive to
        keep and consolidation prefers retiring it first — bit-identical
        to the nominal price at λ=0 (the risk-blind default)."""
        o = self.current_offering()
        return (effective_price(o, self._risk_lambda)
                if o is not None else 0.0)

    def current_offering(self):
        """The catalog Offering this node runs on, or None (delisted)."""
        if self.instance_type is None:
            return None
        for o in self.instance_type.offerings:
            if o.zone == self.zone and o.capacity_type == self.capacity_type:
                return o
        return None

    def __repr__(self):
        return f"Candidate({self.name}, cost={self.disruption_cost:.2f})"


DELETE = "delete"
REPLACE = "replace"
NOOP = "no-op"


class Command:
    def __init__(self, candidates, replacements=(), reason: str = ""):
        self.candidates = list(candidates)
        self.replacements = list(replacements)  # [InFlightNodeClaim]
        self.reason = reason
        # orchestration bookkeeping
        self.replacement_names: list = []
        self.created_at: float = 0.0
        self.last_error: str | None = None
        # criterion-predicted savings rate, stamped at execution for the
        # fleet ledger's reconciliation (obs/timeline.py); None when the
        # command was unpriceable
        self.predicted_savings: float | None = None

    @property
    def action(self) -> str:
        if self.replacements:
            return REPLACE
        if self.candidates:
            return DELETE
        return NOOP

    def __repr__(self):
        return (
            f"Command({self.action}, reason={self.reason}, "
            f"candidates={[c.name for c in self.candidates]}, "
            f"replacements={len(self.replacements)})"
        )
