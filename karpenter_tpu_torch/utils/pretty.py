"""ChangeMonitor: emit-on-change gate for noisy log/event sites.

Behavioral mirror of the reference's pkg/utils/pretty/change_monitor.go:
callers ask ``has_changed(key, value)`` before logging; the answer is True
only when the key is new, the value differs from the last one seen for that
key, or the entry has outlived its TTL. Unlike the event recorder's 90 s
exact-message dedupe (operator/events.py), this suppresses *stable* states
indefinitely (up to the TTL) while letting any CHANGE through immediately —
the right shape for per-pod FailedScheduling chatter, where the same
unschedulable pod re-reports every batch.

The port's copy of ``karpenter_tpu/utils/pretty.py`` (imports changed).
"""

from __future__ import annotations

DEFAULT_TTL = 24 * 3600.0  # change_monitor.go: 24h


class ChangeMonitor:
    def __init__(self, ttl: float = DEFAULT_TTL, clock=None):
        from karpenter_tpu_torch.utils.clock import Clock

        self.ttl = ttl
        self.clock = clock or Clock()
        self._seen: dict = {}  # key -> (expiry, value hash)

    def has_changed(self, key, value) -> bool:
        """True iff `value` for `key` is new/changed/expired; records it."""
        now = self.clock.now()
        h = hash(repr(value))
        cached = self._seen.get(key)
        if cached is not None and cached[0] > now and cached[1] == h:
            return False
        if len(self._seen) > 8192:  # expired entries drain lazily
            self._seen = {k: v for k, v in self._seen.items() if v[0] > now}
        self._seen[key] = (now + self.ttl, h)
        return True

    def forget(self, key):
        self._seen.pop(key, None)
