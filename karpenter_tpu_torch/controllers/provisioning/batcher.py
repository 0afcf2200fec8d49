"""Pod-arrival debounce window.

Mirror of the reference's Batcher (pkg/controllers/provisioning/
batcher.go:29-75): after the first trigger, wait until `idle_duration`
passes without new triggers, capped at `max_duration` total — batching a
burst of pending pods into one solve.

The port's copy of ``karpenter_tpu/controllers/provisioning/batcher.py`` (imports changed).
"""

from __future__ import annotations

DEFAULT_IDLE = 1.0
DEFAULT_MAX = 10.0


class Batcher:
    def __init__(self, clock, idle_duration: float = DEFAULT_IDLE, max_duration: float = DEFAULT_MAX):
        self.clock = clock
        self.idle_duration = idle_duration
        self.max_duration = max_duration
        self._last_trigger: float | None = None
        self._window_start: float | None = None

    def trigger(self):
        now = self.clock.now()
        self._last_trigger = now
        if self._window_start is None:
            self._window_start = now

    @property
    def triggered(self) -> bool:
        return self._window_start is not None

    def ready(self) -> bool:
        """True when the batch window has closed and a solve should run."""
        if self._window_start is None:
            return False
        now = self.clock.now()
        if now - self._window_start >= self.max_duration:
            return True
        return now - (self._last_trigger or now) >= self.idle_duration

    def reset(self):
        self._last_trigger = None
        self._window_start = None
