"""The traced run's profiled slice: a few decisions under ``torch.profiler``.

``Slice`` profiles the decisions run inside it (CPU and CUDA activity) and
records, through the program side's ``record_compat`` (``system.py``), the
shapes and ``has`` rows of every compat launch they make.
``Slice.reduce`` turns the profiler's events and the decisions' span trees
into:

- ``kernels``: the CUDA kernel events (copies and fills excluded);
- ``busy_s`` / ``window_s``: the union of all device activity inside the
  slice's decisions, and their length on the host clock;
- ``compat``: ``(least ms, device ms)`` of each compat launch, the least
  time from ``roofline.compat_bound_ms`` at its own shapes;
- ``device_ops``: device seconds by kernel name, the largest ten;
- ``idle_gaps``: the seconds in which no device activity ran, by the
  innermost span the host was in (the round's name where the decision had
  no program span open, ``harness`` outside the round), the largest ten.

The compat launches that ``ops/cuda_kernels.py`` counted (the program
side's ``compat_launches``; none where the side has no such count) must
equal both the launches recorded and the compat kernel events in the trace;
otherwise the profiler dropped records and ``reduce`` raises rather than
report a slice that misses part of its work.
"""

from __future__ import annotations

import contextlib
import time

from portbench import roofline

COMPAT_KERNEL = "compat_kernel"
_COPIES = ("Memcpy", "Memset")


class Slice:
    """``cuda`` False profiles the host alone (the CPU tests' runs).
    ``program`` is the side that decides: its ``compat_launches`` and
    ``record_compat`` count and record the compat launches."""

    def __init__(self, cuda: bool = True, program=None):
        self.cuda = cuda
        self._count = getattr(program, "compat_launches", lambda: 0)
        self._record = getattr(program, "record_compat", None)
        self.calls: list = []
        self.traces: list = []
        self.spans_window: list = []  # (t0, t1) of each decision, host clock

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if self.cuda:
            torch.cuda.synchronize()
        self._launches0 = self._count()
        self._patch = (self._record(self.calls) if self._record is not None
                       else contextlib.nullcontext())
        self._patch.__enter__()
        self._prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else []))
        self._prof.__enter__()
        # the profiler's clock is the wall clock in ns; the spans' is the
        # host's monotonic clock: one marker ties the two together
        self._mark_host = time.perf_counter()
        with record_function("portbench.mark"):
            pass
        return self

    def __exit__(self, et, ev, tb):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(et, ev, tb)
        self._patch.__exit__(et, ev, tb)
        self.launches = self._count() - self._launches0
        return False

    def add(self, t0: float, t1: float, trace) -> None:
        self.spans_window.append((t0, t1))
        if trace is not None:
            self.traces.append(trace)

    def reduce(self) -> dict:
        from torch.autograd import DeviceType

        events = list(self._prof.profiler.kineto_results.events())
        mark = next(e.start_ns() for e in events if e.name() == "portbench.mark")
        offset = mark * 1e-9 - self._mark_host  # profiler s = host s + offset
        w0 = self.spans_window[0][0] + offset
        w1 = self.spans_window[-1][1] + offset
        dev = sorted((e.start_ns() * 1e-9, e.end_ns() * 1e-9, e.name())
                     for e in events if e.device_type() == DeviceType.CUDA)
        dev = [d for d in dev if d[1] > w0 and d[0] < w1]
        kernels = [d for d in dev if not d[2].startswith(_COPIES)]
        compat_ev = [d for d in kernels if COMPAT_KERNEL in d[2]]
        if not (len(compat_ev) == len(self.calls) == self.launches):
            raise RuntimeError(
                f"profiled slice: {self.launches} compat launches counted, "
                f"{len(self.calls)} recorded, {len(compat_ev)} compat kernel "
                "events traced; the profiler dropped records")
        compat = []
        for (s, e, _), call in zip(compat_ev, self.calls):
            G, T, K, W, g_has, t_has = call
            least, _ = roofline.compat_bound_ms(
                G, T, K, W, roofline.defined_pairs(g_has, t_has))
            compat.append((least, (e - s) * 1e3))
        self.calls.clear()

        # busy: the union of device activity inside each decision; the
        # harness's own time between decisions is no part of the window
        busy, gaps = 0.0, []
        for t0, t1 in self.spans_window:
            d0, d1 = t0 + offset, t1 + offset
            cursor = d0
            for s, e, _ in dev:
                if e <= d0 or s >= d1:
                    continue
                s, e = max(s, d0), min(e, d1)
                if s > cursor:
                    gaps.append((cursor, s))
                if e > cursor:
                    busy += e - max(s, cursor)
                    cursor = e
            if d1 > cursor:
                gaps.append((cursor, d1))
        ops: dict = {}
        for s, e, name in dev:
            ops[name] = ops.get(name, 0.0) + (e - s)
        idle = _by_span(gaps, _segments(self.traces, offset))
        top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                               key=lambda kv: -kv[1])[:10]
        return {
            "decisions": len(self.spans_window),
            "kernels": len(kernels),
            "busy_s": busy,
            "window_s": sum(t1 - t0 for t0, t1 in self.spans_window),
            "compat": compat,
            "device_ops": top(ops),
            "idle_gaps": top(idle),
        }


def _segments(traces, offset: float) -> list:
    """The decisions' host time cut into (start, end, span name) pieces,
    each named by the innermost span open then, in the profiler's clock."""
    out = []

    def walk(sp):
        t = sp.t0
        for c in sorted(sp.children, key=lambda c: c.t0):
            if c.t0 > t:
                out.append((t, c.t0, sp.name))
            walk(c)
            t = max(t, c.t0 + (c.dur or 0.0))
        end = sp.t0 + (sp.dur or 0.0)
        if end > t:
            out.append((t, end, sp.name))

    for tr in traces:
        walk(tr.root)
    return sorted((a + offset, b + offset, name) for a, b, name in out)


def _by_span(gaps: list, segments: list) -> dict:
    """Seconds of the sorted ``gaps`` by the segment they fall in; what no
    segment covers (the harness's call around a round) is ``harness``."""
    out: dict = {}
    i = 0
    for a, b in gaps:
        covered = 0.0
        while i < len(segments) and segments[i][1] <= a:
            i += 1
        j = i
        while j < len(segments) and segments[j][0] < b:
            s0, s1, name = segments[j]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
                covered += part
            j += 1
        if b - a > covered:
            out["harness"] = out.get("harness", 0.0) + (b - a - covered)
    return out

