"""Per-round flight recorder: trace ring buffer + Chrome trace dumps.

The port's copy of ``karpenter_tpu/obs/recorder.py`` (imports changed).
The replay capsule an anomalous round writes beside its dump (below) is
left out until capsules are ported (ROADMAP.md Queue 1 item 1).

Keeps the last N completed round traces (:mod:`karpenter_tpu_torch.obs.trace`)
in memory and writes a `Chrome trace-event
<chrome://tracing / Perfetto "trace event format">`_ JSON file for every
round that fired an anomaly trigger (or every round, under
``KARPENTER_TRACE_DUMP=1`` / ``dump_all``). The point is the *one bad
round*: when a bench regresses or a probe falls back in production, the
causal span tree of that exact round is already on disk — no repro run
needed.

Dump format: ``{"traceEvents": [...], "displayTimeUnit": "ms",
"otherData": {...}}``. Spans are complete events (``"ph": "X"``, ``ts``/
``dur`` in microseconds relative to the round start); anomalies are
global instant events (``"ph": "i"``, named ``anomaly:<kind>``); span
``kind`` rides the ``cat`` field so Perfetto can color host vs device vs
cache stages.

Disk writes never take down a reconcile loop: a failed dump logs a
WARNING (the stderr lastResort handler reaches it) and the round
continues. Each recorded trace dumps at most once per round — re-dumping
on demand (``dump(trace)``) reuses the path.

An anomalous round also serializes its pending **replay capsule** — the
round's most recent hot-path solve as a runnable artifact (exact tensor
inputs, outputs, engine/rung, env knobs) — next to the Chrome dump; see
:mod:`karpenter_tpu_torch.obs.capsule` and deploy/README.md "Replay capsules"
(``python -m karpenter_tpu_torch.obs replay <capsule>`` re-executes it
bit-identically offline, ``replay --ab`` races every eligible rung).
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque

__all__ = ["FlightRecorder", "chrome_events"]


def chrome_events(trace) -> list:
    """The trace's span tree + anomaly marks as Chrome trace events."""
    base = trace.root.t0
    events = []
    for sp in trace.spans():
        ev = {
            "name": sp.name,
            "cat": sp.kind,
            "ph": "X",
            "ts": round((sp.t0 - base) * 1e6, 3),
            "dur": round((sp.dur or 0.0) * 1e6, 3),
            "pid": trace.pid,
            "tid": sp.tid,
        }
        if sp.attrs:
            ev["args"] = {k: _jsonable(v) for k, v in sp.attrs.items()}
        events.append(ev)
    for kind, attrs, at in trace.anomalies:
        ev = {
            "name": f"anomaly:{kind}",
            "cat": "anomaly",
            "ph": "i",
            "s": "g",
            "ts": round((at - base) * 1e6, 3),
            "pid": trace.pid,
            "tid": trace.root.tid,
        }
        if attrs:
            ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        events.append(ev)
    return events


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class FlightRecorder:
    """Ring buffer of the last N round traces + the anomaly dump policy."""

    def __init__(self, capacity: int = 32, dump_dir: str | None = None,
                 dump_all: bool = False):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self.dump_dir = dump_dir
        self.dump_all = dump_all

    def configure(self, dump_dir=None, capacity=None, dump_all=None):
        with self._lock:
            if dump_dir is not None:
                self.dump_dir = dump_dir
            if dump_all is not None:
                self.dump_all = dump_all
            if capacity is not None and capacity != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(capacity, 1))

    # -- recording --------------------------------------------------------
    def record(self, trace):
        """Retain a completed round. Rounds that opened no child span and
        fired no anomaly are pure tracer overhead (idle ticks) and are
        skipped so they cannot churn real rounds out of the ring."""
        if not trace.root.children and not trace.anomalies:
            return
        with self._lock:
            self._ring.append(trace)
        if trace.anomalies or self.dump_all:
            self.dump(trace)

    def traces(self) -> list:
        """Retained traces, oldest first."""
        with self._lock:
            return list(self._ring)

    def last(self, name: str | None = None):
        """Most recent retained trace (optionally of a given round name)."""
        with self._lock:
            for tr in reversed(self._ring):
                if name is None or tr.name == name:
                    return tr
        return None

    def clear(self):
        with self._lock:
            self._ring.clear()

    # -- dumping ----------------------------------------------------------
    def dump(self, trace, path: str | None = None) -> str | None:
        """Write one Chrome trace-event JSON file for ``trace``; returns
        the path (idempotent per trace unless an explicit path forces a
        re-write). Never raises: a dump failure must not fail the round
        that triggered it."""
        if path is None and trace.dump_path is not None:
            return trace.dump_path
        try:
            directory = self.dump_dir or "."
            if path is None:
                os.makedirs(directory, exist_ok=True)
                path = os.path.join(
                    directory, f"{trace.name}-{trace.trace_id}.trace.json"
                )
            doc = {
                "traceEvents": chrome_events(trace),
                "displayTimeUnit": "ms",
                "otherData": {
                    "trace_id": trace.trace_id,
                    "round": trace.name,
                    "wall_start": trace.wall_start,
                    "anomalies": [k for k, _, _ in trace.anomalies],
                    "dropped_spans": trace.dropped,
                    # the round's decision-ledger verdicts (obs/decisions):
                    # which rungs this round ran, right next to its spans
                    "decisions": [
                        {"site": s, "rung": r, "reason": why, "n": n}
                        for (s, r, why), n in sorted(
                            getattr(trace, "decisions", {}).items())
                    ],
                },
            }
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f)
        except OSError:
            import logging

            logging.getLogger(__name__).warning(
                "flight recorder failed to dump trace %s", trace.trace_id,
                exc_info=True)
            return None
        trace.dump_path = path
        if trace.registry is not None:
            from karpenter_tpu_torch.operator import metrics as m

            trace.registry.counter(
                m.TRACE_DUMPS, "flight-recorder trace files written"
            ).inc(round=trace.name)
        return path
