"""NodePool: the user-facing pool template.

Field semantics from the reference's pkg/apis/v1beta1/nodepool.go:
NodePoolSpec :40, Disruption :64 (consolidationPolicy :139-144), Budget
:102-136 (count/percent nodes, cron schedule + duration, per-reason),
GetAllowedDisruptions :271, Budget.IsActive :318, Limits.ExceededBy
(nodepool_status.go).
"""

from __future__ import annotations

import hashlib
import json
import math
import time
from dataclasses import dataclass, field

from karpenter_tpu_torch.api.conditions import ConditionedObject
from karpenter_tpu_torch.api.objects import ObjectMeta
from karpenter_tpu_torch.utils import resources as resutil
from karpenter_tpu_torch.utils.cron import parse_schedule

CONSOLIDATION_WHEN_EMPTY = "WhenEmpty"
CONSOLIDATION_WHEN_UNDERUTILIZED = "WhenUnderutilized"

# disruption reasons (v1beta1 uses one budget list for all reasons unless set)
REASON_UNDERUTILIZED = "Underutilized"
REASON_EMPTY = "Empty"
REASON_DRIFTED = "Drifted"
REASON_EXPIRED = "Expired"
ALL_REASONS = (REASON_UNDERUTILIZED, REASON_EMPTY, REASON_DRIFTED, REASON_EXPIRED)
# spot interruption is INVOLUNTARY disruption: the provider reclaims the
# capacity whether or not a budget window is open, so the proactive drain
# is not budget-gated and the reason stays OUT of ALL_REASONS (budgets
# bound voluntary disruption only — the reference's interruption
# controller takes the same stance)
REASON_INTERRUPTED = "Interrupted"


@dataclass
class Budget:
    """Active-window cap on concurrent disruptions (nodepool.go:102-136)."""

    nodes: str = "10%"  # absolute count ("5") or percentage ("10%")
    schedule: str | None = None  # cron, UTC; None = always active
    duration: float | None = None  # seconds the window stays open
    reasons: list | None = None  # None = applies to all reasons

    def is_active(self, now: float | None = None) -> bool:
        """True when the budget window is open (Budget.IsActive nodepool.go:318)."""
        if self.schedule is None and self.duration is None:
            return True
        try:
            sched = parse_schedule(self.schedule or "* * * * *")
        except ValueError:
            # invalid schedules are rejected at admission by the validation
            # controller; at runtime an unparseable budget is inert
            return False
        if self.duration is None:
            # schedule without duration: the window never closes, so the
            # budget is simply always active (CEL validation in the
            # reference requires the pair to be set together)
            return True
        now = time.time() if now is None else now
        # Active iff a firing occurred within the last `duration`; bounding
        # the lookback keeps sparse schedules (@yearly) off the hot path.
        lookback = int(self.duration // 60) + 2
        last = sched.prev(now, lookback_minutes=lookback)
        return last is not None and last <= now < last + self.duration

    def allowed(self, total_nodes: int, now: float | None = None) -> int:
        if not self.is_active(now):
            return total_nodes  # inactive budget imposes no cap
        s = str(self.nodes).strip()
        if s.endswith("%"):
            # percentages round UP (intstr.GetScaledValueFromIntOrPercent
            # with roundUp=true in GetAllowedDisruptions): a 10% budget on a
            # 1-node pool still allows one disruption
            return int(math.ceil(total_nodes * float(s[:-1]) / 100.0))
        return int(s)


@dataclass
class Disruption:
    consolidation_policy: str = CONSOLIDATION_WHEN_UNDERUTILIZED
    consolidate_after: float | None = None  # seconds; None = immediate for WhenUnderutilized
    expire_after: float | None = None  # seconds; None = Never
    budgets: list = field(default_factory=lambda: [Budget(nodes="10%")])


@dataclass
class NodeClaimTemplate:
    """spec.template: metadata + claim spec stamped onto every NodeClaim."""

    labels: dict = field(default_factory=dict)
    annotations: dict = field(default_factory=dict)
    # NodeClaimSpec fields (pkg/apis/v1beta1/nodeclaim.go:26)
    taints: list = field(default_factory=list)
    startup_taints: list = field(default_factory=list)
    requirements: list = field(default_factory=list)  # [NodeSelectorRequirement]
    resource_requests: dict = field(default_factory=dict)
    kubelet: dict = field(default_factory=dict)
    node_class_ref: dict = field(default_factory=dict)  # {"kind","name","apiVersion"}


@dataclass
class NodePoolSpec:
    template: NodeClaimTemplate = field(default_factory=NodeClaimTemplate)
    disruption: Disruption = field(default_factory=Disruption)
    limits: dict = field(default_factory=dict)  # resource name -> quantity
    weight: int = 0


@dataclass
class NodePoolStatus:
    resources: dict = field(default_factory=dict)  # aggregated owned-node resources
    conditions: list = field(default_factory=list)


@dataclass
class NodePool(ConditionedObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodePoolSpec = field(default_factory=NodePoolSpec)
    status: NodePoolStatus = field(default_factory=NodePoolStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    def allowed_disruptions(self, reason: str, total_nodes: int, now: float | None = None) -> int:
        """min over active budgets applying to reason (GetAllowedDisruptions
        nodepool.go:271)."""
        allowed = total_nodes
        for b in self.spec.disruption.budgets:
            if b.reasons is not None and reason not in b.reasons:
                continue
            allowed = min(allowed, b.allowed(total_nodes, now))
        return max(allowed, 0)

    def limits_exceeded(self, usage: dict) -> list:
        """Resources for which usage exceeds spec.limits (Limits.ExceededBy)."""
        return resutil.exceeds(usage, self.spec.limits)

    def static_hash(self) -> str:
        """Hash of drift-relevant static fields (basis of the nodepool-hash
        annotation, nodepool/hash/controller.go:49)."""
        t = self.spec.template
        payload = {
            "labels": t.labels,
            "annotations": t.annotations,
            "taints": [(x.key, x.value, x.effect) for x in t.taints],
            "startup_taints": [(x.key, x.value, x.effect) for x in t.startup_taints],
            "kubelet": t.kubelet,
            "node_class_ref": t.node_class_ref,
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True, default=str).encode()
        ).hexdigest()[:16]
