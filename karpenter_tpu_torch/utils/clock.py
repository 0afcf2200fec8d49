"""Clock abstraction: real time for the operator, fake time for tests
(the reference's envtest suites inject a fake clock the same way).

The port's copy of ``karpenter_tpu/utils/clock.py`` (imports changed).
"""

from __future__ import annotations

import threading
import time as _time


class Clock:
    def now(self) -> float:
        return _time.time()

    def sleep(self, seconds: float):
        _time.sleep(seconds)


class FakeClock(Clock):
    def __init__(self, start: float = 1_700_000_000.0):
        self._now = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float):
        self.step(seconds)

    def step(self, seconds: float):
        with self._lock:
            self._now += seconds

    def set(self, t: float):
        with self._lock:
            self._now = t
