"""Minimal 5-field cron schedule (UTC) for disruption-budget windows.

The reference parses Budget.Schedule with robfig/cron (nodepool.go:318);
we implement the standard minute/hour/dom/month/dow grammar with lists,
ranges, and steps — enough for the budget use case without a dependency.
"""

from __future__ import annotations

import functools
import time


def _parse_field(spec: str, lo: int, hi: int, wrap: int | None = None) -> frozenset:
    """wrap: a value that aliases lo (Vixie cron allows dow 7 == Sunday)."""
    out = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part == "*" or part == "":
            rng = range(lo, hi + 1)
        elif "-" in part:
            a, b = part.split("-", 1)
            rng = range(int(a), int(b) + 1)
        else:
            v = int(part)
            rng = range(v, v + 1)
        for x in rng:
            if (x - rng.start) % step:
                continue
            if x == wrap:
                x = lo
            if not lo <= x <= hi:
                raise ValueError(f"cron field value {x} out of range [{lo},{hi}] in {spec!r}")
            out.add(x)
    return frozenset(out)


class CronSchedule:
    def __init__(self, spec: str):
        spec = spec.strip()
        aliases = {
            "@hourly": "0 * * * *",
            "@daily": "0 0 * * *",
            "@midnight": "0 0 * * *",
            "@weekly": "0 0 * * 0",
            "@monthly": "0 0 1 * *",
            "@yearly": "0 0 1 1 *",
            "@annually": "0 0 1 1 *",
        }
        spec = aliases.get(spec, spec)
        fields = spec.split()
        if len(fields) != 5:
            raise ValueError(f"invalid cron spec {spec!r}")
        self.minutes = _parse_field(fields[0], 0, 59)
        self.hours = _parse_field(fields[1], 0, 23)
        self.dom = _parse_field(fields[2], 1, 31)
        self.months = _parse_field(fields[3], 1, 12)
        self.dow = _parse_field(fields[4], 0, 6, wrap=7)  # 0 (or 7) = Sunday
        self.dom_wild = fields[2] == "*"
        self.dow_wild = fields[4] == "*"

    def _matches(self, t: time.struct_time) -> bool:
        if t.tm_min not in self.minutes or t.tm_hour not in self.hours:
            return False
        if t.tm_mon not in self.months:
            return False
        dow = (t.tm_wday + 1) % 7  # python: Mon=0 → cron: Sun=0
        dom_ok = t.tm_mday in self.dom
        dow_ok = dow in self.dow
        # standard cron rule: if both dom and dow are restricted, OR them
        if not self.dom_wild and not self.dow_wild:
            return dom_ok or dow_ok
        return dom_ok and dow_ok

    def prev(self, now: float, lookback_minutes: int = 366 * 24 * 60) -> float | None:
        """Most recent firing time <= now, or None within the lookback."""
        minute = int(now // 60) * 60
        for _ in range(lookback_minutes):
            if self._matches(time.gmtime(minute)):
                return float(minute)
            minute -= 60
        return None

    def next(self, now: float, lookahead_days: int = 366) -> float | None:
        minute = (int(now // 60) + 1) * 60
        for _ in range(lookahead_days * 24 * 60):
            if self._matches(time.gmtime(minute)):
                return float(minute)
            minute += 60
        return None


@functools.lru_cache(maxsize=512)
def parse_schedule(spec: str) -> CronSchedule:
    """Cached parse — Budget.is_active runs on every reconcile loop."""
    return CronSchedule(spec)
