"""Shared status-condition helpers for API objects.

The reference gets these from knative/apis condition sets; here one mixin
serves NodeClaim and NodePool (both keep conditions in status.conditions).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Condition:
    type: str
    status: str = "True"  # True | False | Unknown
    reason: str = ""
    message: str = ""
    last_transition_time: float = field(default_factory=time.time)

    @classmethod
    def from_wire(cls, c: dict) -> "Condition":
        """One normalizer for dict-shaped conditions (wire docs, test
        fixtures) — every entry point must share it or the shapes drift.
        A missing transition time reads as NOW: age-gated consumers
        (emptiness consolidate_after, drift ordering) must restart their
        waits rather than treat the condition as epoch-old."""
        return cls(
            type=c["type"], status=c.get("status", "Unknown"),
            reason=c.get("reason", ""), message=c.get("message", ""),
            last_transition_time=c.get("lastTransitionTime") or time.time(),
        )


class ConditionedObject:
    """Mixin for objects with status.conditions: get/set/clear/is_true.

    is_true returns False for a missing condition — callers that want
    "unreconciled means ready" (e.g. the provisioner's nodepool gate) must
    check get_condition() is None explicitly.
    """

    def get_condition(self, cond_type: str):
        for i, c in enumerate(self.status.conditions):
            if isinstance(c, dict):
                if c.get("type") != cond_type:
                    continue
                # normalize dict-shaped conditions in place so set_condition
                # and clear_condition can rely on attribute access
                c = Condition.from_wire(c)
                self.status.conditions[i] = c
                return c
            if c.type == cond_type:
                return c
        return None

    def set_condition(self, cond_type: str, status: str = "True", reason: str = "",
                      message: str = "", now: float | None = None):
        existing = self.get_condition(cond_type)
        if existing is not None:
            if existing.status != status:
                existing.status = status
                existing.last_transition_time = time.time() if now is None else now
            existing.reason = reason
            existing.message = message
            return existing
        c = Condition(type=cond_type, status=status, reason=reason, message=message,
                      last_transition_time=time.time() if now is None else now)
        self.status.conditions.append(c)
        return c

    def clear_condition(self, cond_type: str):
        self.status.conditions = [
            c for c in self.status.conditions
            if (c.get("type") if isinstance(c, dict) else c.type) != cond_type
        ]

    def is_true(self, cond_type: str) -> bool:
        c = self.get_condition(cond_type)
        return c is not None and c.status == "True"
