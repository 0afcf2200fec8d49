"""Event recorder: deduplicated, rate-limited k8s Events.

Mirror of the reference's pkg/events/recorder.go:47-98: identical events
within a 90 s TTL are emitted once (the dedupe cache keys on reason +
involved object + message), and a token bucket caps the global emission
rate so an event storm can't flood the apiserver. Events land in the
hermetic store's "events" kind when a store is attached, and are always
kept in a bounded in-memory ring for test assertions.

The port's copy of ``karpenter_tpu/operator/events.py`` (imports changed).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

DEDUPE_TTL = 90.0  # recorder.go:47
RATE_LIMIT_QPS = 10.0  # recorder.go flowcontrol bucket
RATE_LIMIT_BURST = 25


@dataclass
class EventRecord:
    reason: str
    message: str
    type: str = "Normal"  # Normal | Warning
    object_kind: str = ""
    object_name: str = ""
    timestamp: float = 0.0
    count: int = 1
    metadata: object = field(default=None)


class Recorder:
    def __init__(self, clock=None, store=None, keep: int = 1000):
        from karpenter_tpu_torch.utils.clock import Clock

        self.clock = clock or Clock()
        self.store = store
        self.events: deque = deque(maxlen=keep)
        self._seen: dict = {}  # dedupe key -> (expiry, EventRecord)
        self._tokens = float(RATE_LIMIT_BURST)
        self._last_refill = self.clock.now()
        self.dropped = 0

    def publish(self, reason: str, message: str, obj=None, type: str = "Normal"):
        now = self.clock.now()
        kind = type_name(obj)
        name = getattr(getattr(obj, "metadata", None), "name", "") if obj is not None else ""
        key = (reason, kind, name, message)

        # dedupe window: repeat events bump the count on the cached record
        cached = self._seen.get(key)
        if cached is not None and cached[0] > now:
            cached[1].count += 1
            return None

        # token-bucket rate limit
        self._tokens = min(
            RATE_LIMIT_BURST, self._tokens + (now - self._last_refill) * RATE_LIMIT_QPS
        )
        self._last_refill = now
        if self._tokens < 1.0:
            self.dropped += 1
            return None
        self._tokens -= 1.0

        rec = EventRecord(
            reason=reason, message=message, type=type,
            object_kind=kind, object_name=name, timestamp=now,
        )
        self._seen[key] = (now + DEDUPE_TTL, rec)
        if len(self._seen) > 4096:  # TTL-expired entries drain lazily
            self._seen = {k: v for k, v in self._seen.items() if v[0] > now}
        self.events.append(rec)
        if self.store is not None:
            from karpenter_tpu_torch.api.objects import ObjectMeta

            rec.metadata = ObjectMeta(
                name=f"evt-{reason.lower()}-{int(now * 1000) % 10**9}-{len(self.events)}",
                namespace="default",
            )
            try:
                self.store.create("events", rec)
            except Exception:
                pass  # events are best-effort
        return rec

    # -- test helpers (the reference's test eventrecorder double) --------
    def reasons(self) -> list:
        return [e.reason for e in self.events]

    def by_reason(self, reason: str) -> list:
        return [e for e in self.events if e.reason == reason]


def type_name(obj) -> str:
    return type(obj).__name__ if obj is not None else ""
