"""In-process span tracer for the provision/disrupt hot paths.

The port's copy of ``karpenter_tpu/obs/trace.py`` (imports changed).
The text below is the JAX package's, with the port's
names: on the card a ``device`` span brackets the eager launch of the
pack loop (``solve.dispatch``) and the one readback (``solve.block``).

The perf stack is a ladder of caches, delta paths, and
probe-confirm rungs whose SLOW edges — opaque snapshot rebuilds, extra
host confirms, host-routed pods, the sequential waves oracle — used to
surface only as scattered counters. This module gives every reconcile
round a causal story instead: a tree of context-manager spans with
monotonic timing, parent links, and structured attributes, cheap enough
to stay on by default (see the slow overhead test in tests/test_obs.py:
tracer-on grid-1000 stays within 2% of tracer-off).

Model
-----

- A **round** (``round_trace``) is the root of one trace: one provisioner
  solve batch, one disruption poll, one binder pass. Rounds hand their
  finished trace to the :class:`~karpenter_tpu_torch.obs.recorder.FlightRecorder`
  ring buffer and feed span self-time histograms into the round's metrics
  registry (``karpenter_trace_span_self_seconds{span,kind}``).
- A **span** (``span``) nests under the thread's innermost open span.
  Spans carry a ``kind`` separating where wall clock is spent:
  ``host`` (Python control flow, decode, FFD), ``device`` (kernel
  dispatch and the ``block_until_ready``-equivalent host pull — the
  bracketing in models/solver.py ``_invoke`` and
  ops/consolidate.py ``dispatch``), and ``cache`` (tensorization,
  snapshot build/delta-advance — the stages whose hit/miss behavior the
  caches govern).
- An **anomaly** (``anomaly``) marks the current trace as worth keeping:
  the recorder dumps exactly one Chrome trace-event JSON file per
  anomalous round. The wired triggers are ``probe-fallback`` (a device
  consolidation probe raised and the sequential search took over),
  ``multi-host-confirms`` (>1 confirming simulation in one MultiNode
  round — the batched ladder's ≤1 target missed), ``snapshot-rebuild``
  (the disruption snapshot cache paid a full tensorization while holding
  a prior bundle — the delta path declined), ``host-routed`` (a live
  provisioning batch sent pods to the host engine), ``negative-avail``
  (tensorize_existing clamped a negative availability), and
  ``cold-compile-in-steady-state`` (the device-plane compile ledger,
  :mod:`karpenter_tpu_torch.obs.devplane`, saw a cold XLA compile after a long
  warm streak — shape-key churn or cache eviction in what should be a
  compiled-once steady state). Each also counts in
  ``karpenter_trace_anomalies_total{kind}``.

Threading: spans are attached via a thread-local stack, so concurrent
threads can never corrupt each other's parent links; a worker thread can
join an existing trace with ``attach(trace)``. Mutation of the shared
trace structure is guarded by the trace's lock. A thread with no active
trace gets no-op spans (a shared singleton — no allocation).

Profiler ranges: while a ``torch.profiler`` records on the calling
thread, each span and each round (``round <trace id>``) also opens a
profiler range of the same name, closed with it, so the profiler's own
trace holds the program's spans on its clock and each kernel nests,
through the op that launched it, under the span that launched it (the
``KARPENTER_PROFILE_DIR`` dumps, any caller's profiler). The range is
PyTorch's function-scope record (``_RecordFunctionFast``, a ``cpu_op``
event), not ``record_function``'s user annotation: a user annotation
also lays a ``gpu_user_annotation`` event over the device's timeline,
which a reader of device activity counts as a kernel and as busy time.
With no profiler recording a span pays one check and makes no range.

Safety: span enter/exit must NEVER execute inside the pack loop
(``ops/kernels.py`` ``pack``/``solve_step``/``probe_step``) or
``ops/cuda_kernels.py``: a call per pack step would add host work to a
loop that is already launch-bound (the JAX package's GL403–GL406 forbid
the same calls in traced code; ``tests/test_torch_obs.py`` scans the two
modules).

Knobs (resolved at import; ``configure()`` overrides in-process):

- ``KARPENTER_TRACE=0`` disables the tracer entirely (no-op spans).
- ``KARPENTER_TRACE_DIR`` — dump directory (default
  ``<tempdir>/karpenter-traces``).
- ``KARPENTER_TRACE_DUMP=1`` — dump every recorded round, not just
  anomalous ones (the on-demand flag; ``python -m perf --json`` uses the
  equivalent API to attach a dump per bench row).
- ``KARPENTER_TRACE_RING`` — flight-recorder capacity (default 32).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time

from torch._C import _profiler as _torch_profiler
from torch._C._autograd import _profiler_enabled

from karpenter_tpu_torch.utils import envknobs

__all__ = [
    "Span",
    "Trace",
    "Tracer",
    "TRACER",
    "RECORDER",
    "span",
    "round_trace",
    "anomaly",
    "attach",
    "current_trace_id",
    "configure",
    "discard_round",
    "reset",
]

# spans a single trace may hold before new ones are dropped (and counted
# in Trace.dropped): a runaway loop must degrade the trace, not memory
MAX_SPANS_PER_TRACE = 20000


class Span:
    """One timed region. ``dur`` is None while the span is open; ``t0`` is
    a monotonic perf_counter reading (the trace anchors it to wall time)."""

    __slots__ = ("name", "kind", "t0", "dur", "tid", "attrs", "children")

    def __init__(self, name: str, kind: str, tid: int, attrs: dict | None):
        self.name = name
        self.kind = kind
        self.t0 = time.perf_counter()
        self.dur = None
        self.tid = tid
        self.attrs = attrs
        self.children: list = []

    def self_seconds(self) -> float:
        """Duration minus the time spent inside child spans."""
        d = self.dur or 0.0
        return max(d - sum(c.dur or 0.0 for c in self.children), 0.0)


class Trace:
    """One finished-or-in-flight round: a root span, its tree, and the
    anomaly marks that decide whether the recorder dumps it."""

    def __init__(self, trace_id: str, name: str, registry=None,
                 attrs: dict | None = None):
        self.trace_id = trace_id
        self.name = name
        self.registry = registry
        self.pid = os.getpid()
        self.wall_start = time.time()
        self.root = Span(name, "host", threading.get_ident(), attrs)
        self.anomalies: list = []  # (kind, attrs, perf_counter stamp)
        # (site, rung, reason) -> count: the round's decision-ledger
        # verdicts (obs/decisions.py), carried into the Chrome dump
        self.decisions: dict = {}
        self.dropped = 0
        self.dump_path: str | None = None
        # the round's pending replay capture (obs/capsule.py): the most
        # recent hot-path solve's tensorized inputs+outputs, kept by
        # REFERENCE (no copy, no serialization) so anomaly-free rounds pay
        # ~nothing; serialized to a capsule file next to the Chrome dump
        # only when the round closes anomalous (or KARPENTER_CAPSULE=1)
        self.capsule_pending: dict | None = None
        self.capsule_path: str | None = None
        # node-lifecycle events staged by the fleet ledger
        # (obs/timeline.py): committed to the timeline ring only when the
        # round keeps, so an idle round cannot grow it
        self.events: list = []
        # an idle round (the owner found nothing to do) opts out of the
        # ring and the histograms so it cannot churn real rounds out; an
        # anomaly overrides the discard — anomalous rounds always keep
        self.discarded = False
        self._lock = threading.Lock()
        self._n = 1

    # -- structure (thread-safe: spans may arrive from attached threads) --
    def add_child(self, parent: Span, child: Span) -> bool:
        with self._lock:
            if self._n >= MAX_SPANS_PER_TRACE:
                self.dropped += 1
                return False
            self._n += 1
            parent.children.append(child)
            return True

    def add_anomaly(self, kind: str, attrs: dict | None):
        with self._lock:
            self.anomalies.append((kind, attrs, time.perf_counter()))

    def add_decision(self, site: str, rung: str, reason: str):
        with self._lock:
            key = (site, rung, reason)
            self.decisions[key] = self.decisions.get(key, 0) + 1

    def add_event(self, event: dict):
        """Stage one fleet-ledger lifecycle event (obs/timeline.py) for
        commit at round close."""
        with self._lock:
            self.events.append(event)

    def add_capture(self, record: dict):
        """Attach a replay-capture record (last one wins — the round's
        most recent solve is the one an anomaly usually indicts)."""
        with self._lock:
            self.capsule_pending = record

    # -- derived views (call after the round closed) ----------------------
    def spans(self):
        """Every span, pre-order, root first."""
        out, stack = [], [self.root]
        while stack:
            s = stack.pop()
            out.append(s)
            stack.extend(reversed(s.children))
        return out

    def self_times(self) -> dict:
        """span name -> [total self seconds, count] over the tree."""
        agg: dict = {}
        for s in self.spans():
            e = agg.setdefault(s.name, [0.0, 0])
            e[0] += s.self_seconds()
            e[1] += 1
        return agg

    def summary(self, top: int = 5) -> list:
        """Top-N spans by aggregate self time (the perf-row embed)."""
        agg = self.self_times()
        rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
        return [
            {"span": name, "self_ms": round(tot * 1000.0, 3), "count": n}
            for name, (tot, n) in rows
        ]

    def leaf_coverage(self) -> float:
        """Fraction of the round's wall clock attributed to spans BELOW
        the root — the instrumentation-coverage number the acceptance
        criterion pins (≥95% on a 300-node consolidation round)."""
        d = self.root.dur or 0.0
        if d <= 0.0:
            return 1.0
        return 1.0 - self.root.self_seconds() / d


class _NopSpan:
    """Shared do-nothing context manager for disabled/unrooted spans."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, et, ev, tb):
        return False


_NOP = _NopSpan()


def _open_range(name: str):
    """A profiler range named ``name``, entered; the caller has checked
    that a profiler records on this thread."""
    rf = _torch_profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


class _SpanHandle:
    __slots__ = ("_tracer", "_span", "_attached", "_range")

    def __init__(self, tracer: "Tracer", sp: Span, attached: bool):
        self._tracer = tracer
        self._span = sp
        self._attached = attached
        self._range = None

    def __enter__(self):
        if self._attached:
            self._tracer._tls.stack.append(self._span)
        if _profiler_enabled():
            self._range = _open_range(self._span.name)
        return self._span

    def __exit__(self, et, ev, tb):
        sp = self._span
        sp.dur = time.perf_counter() - sp.t0
        if self._range is not None:
            self._range.__exit__(et, ev, tb)
        if et is not None:
            if sp.attrs is None:
                sp.attrs = {}
            sp.attrs["error"] = getattr(et, "__name__", str(et))
        if self._attached:
            stack = self._tracer._tls.stack
            if stack and stack[-1] is sp:
                stack.pop()
        return False


class _RoundHandle:
    __slots__ = ("_tracer", "_trace", "_range")

    def __init__(self, tracer: "Tracer", trace: Trace):
        self._tracer = tracer
        self._trace = trace
        self._range = None

    def __enter__(self):
        tls = self._tracer._tls
        tls.trace = self._trace
        tls.stack = [self._trace.root]
        if _profiler_enabled():
            self._range = _open_range(f"round {self._trace.trace_id}")
        return self._trace

    def __exit__(self, et, ev, tb):
        tr = self._trace
        tr.root.dur = time.perf_counter() - tr.root.t0
        if self._range is not None:
            self._range.__exit__(et, ev, tb)
        if et is not None:
            if tr.root.attrs is None:
                tr.root.attrs = {}
            tr.root.attrs["error"] = getattr(et, "__name__", str(et))
        tls = self._tracer._tls
        tls.trace = None
        tls.stack = []
        self._tracer._finish(tr)
        return False


class _Attach:
    """Joins a worker thread to an existing trace (root-parented spans)."""

    __slots__ = ("_tracer", "_trace")

    def __init__(self, tracer: "Tracer", trace: Trace):
        self._tracer = tracer
        self._trace = trace

    def __enter__(self):
        tls = self._tracer._tls
        tls.trace = self._trace
        tls.stack = [self._trace.root]
        return self._trace

    def __exit__(self, et, ev, tb):
        tls = self._tracer._tls
        tls.trace = None
        tls.stack = []
        return False


class Tracer:
    """The process tracer. One module-level instance (``TRACER``) is the
    production default — components reach it through the module helpers
    ``span``/``round_trace``/``anomaly`` so tests can ``configure()`` it
    without re-wiring every controller."""

    def __init__(self, enabled: bool = True, recorder=None):
        self.enabled = enabled
        self.recorder = recorder
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._seq = 0

    # -- thread-local plumbing -------------------------------------------
    @property
    def _stack(self) -> list:
        tls = self._tls
        if not hasattr(tls, "stack"):
            tls.stack = []
            tls.trace = None
        return tls.stack

    def current_trace(self) -> Trace | None:
        self._stack  # materialize the thread-local slots
        return self._tls.trace

    def current_trace_id(self) -> str | None:
        tr = self.current_trace()
        return tr.trace_id if tr is not None else None

    def _new_id(self) -> str:
        with self._lock:
            self._seq += 1
            seq = self._seq
        return f"{os.getpid():x}-{seq:04x}"

    # -- the public surface ----------------------------------------------
    def round_trace(self, name: str, registry=None, **attrs):
        """Open a round: the root of a new trace. Degrades to a plain
        child span when a trace is already active on this thread (a
        simulation re-entering the provisioner must not steal the
        disruption round's recorder slot)."""
        if not self.enabled:
            return _NOP
        if self.current_trace() is not None:
            return self.span(name, **attrs)
        _ensure_log_context()
        tr = Trace(self._new_id(), name, registry=registry,
                   attrs=attrs or None)
        return _RoundHandle(self, tr)

    def span(self, name: str, kind: str = "host", **attrs):
        """A timed region under the thread's innermost open span. No-op
        (shared singleton, no allocation) when the tracer is disabled or
        the thread has no active trace."""
        if not self.enabled:
            return _NOP
        stack = self._stack
        if not stack:
            return _NOP
        tr = self._tls.trace
        sp = Span(name, kind, threading.get_ident(), attrs or None)
        attached = tr.add_child(stack[-1], sp)
        if not attached:
            return _NOP
        return _SpanHandle(self, sp, attached)

    def anomaly(self, kind: str, registry=None, **attrs):
        """Mark the current trace (if any) as anomalous and count the
        trigger. The recorder dumps one Chrome trace file per anomalous
        round when the trace closes."""
        if not self.enabled:
            return
        tr = self.current_trace()
        reg = registry if registry is not None else (
            tr.registry if tr is not None else None
        )
        if reg is not None:
            from karpenter_tpu_torch.operator import metrics as m

            reg.counter(
                m.TRACE_ANOMALIES,
                "anomaly triggers observed by the reconcile flight recorder",
            ).inc(kind=kind)
        if tr is not None:
            tr.add_anomaly(kind, attrs or None)

    def attach(self, trace: Trace):
        """Context manager joining THIS thread to ``trace`` (spans parent
        under the trace root). For worker threads fanned out inside a
        round."""
        if not self.enabled or trace is None:
            return _NOP
        return _Attach(self, trace)

    def discard_round(self):
        """Mark the current round as idle — it skips the ring buffer and
        the histograms (unless an anomaly fired, which always wins). For
        owners whose polling loop ticks with nothing to do: a quiet
        cluster must not churn its one interesting round out of the
        flight recorder."""
        tr = self.current_trace()
        if tr is not None:
            tr.discarded = True

    # -- round completion -------------------------------------------------
    def _finish(self, trace: Trace):
        if trace.discarded and not trace.anomalies:
            return
        self._feed_metrics(trace)
        if trace.decisions:
            # the decision ledger keeps a last-K ring of per-round rung
            # summaries for the /introspect surface (obs/decisions.py)
            from karpenter_tpu_torch.obs import decisions as _decisions

            _decisions.note_round(trace)
        rec = self.recorder
        if rec is not None:
            rec.record(trace)
        if trace.events:
            # the fleet ledger commits the round's staged lifecycle
            # events AFTER the recorder ran, so the round's capsule ref
            # (when one was written) rides on the committed events
            from karpenter_tpu_torch.obs import timeline as _timeline

            _timeline.note_round(trace)

    def _feed_metrics(self, trace: Trace):
        registry = trace.registry
        if registry is None:
            return
        from karpenter_tpu_torch.operator import metrics as m

        registry.histogram(
            m.TRACE_ROUND_SECONDS, "traced reconcile round durations"
        ).observe(trace.root.dur or 0.0, round=trace.name)
        hist = registry.histogram(
            m.TRACE_SPAN_SECONDS,
            "per-span self time (span tree leaves feed the stage "
            "attribution story)",
        )
        for sp in trace.spans():
            if sp is trace.root:
                continue
            hist.observe(sp.self_seconds(), span=sp.name, kind=sp.kind)


# ---------------------------------------------------------------------------
# module singletons + env wiring
# ---------------------------------------------------------------------------

def _env_enabled() -> bool:
    return envknobs.env_bool("KARPENTER_TRACE", True)


def _env_dump_all() -> bool:
    return (envknobs.env_str("KARPENTER_TRACE_DUMP", "") or "").strip().lower() in (
        "1", "all", "true", "yes", "on",
    )


def _env_dir() -> str:
    return envknobs.env_str("KARPENTER_TRACE_DIR") or os.path.join(
        tempfile.gettempdir(), "karpenter-traces"
    )


def _env_capacity() -> int:
    return envknobs.env_int("KARPENTER_TRACE_RING", 32, minimum=1)


def _build_recorder():
    from karpenter_tpu_torch.obs.recorder import FlightRecorder

    return FlightRecorder(
        capacity=_env_capacity(), dump_dir=_env_dir(),
        dump_all=_env_dump_all(),
    )


RECORDER = _build_recorder()
TRACER = Tracer(enabled=_env_enabled(), recorder=RECORDER)


def span(name: str, kind: str = "host", **attrs):
    return TRACER.span(name, kind=kind, **attrs)


def round_trace(name: str, registry=None, **attrs):
    return TRACER.round_trace(name, registry=registry, **attrs)


def anomaly(kind: str, registry=None, **attrs):
    return TRACER.anomaly(kind, registry=registry, **attrs)


def attach(trace: Trace):
    return TRACER.attach(trace)


def discard_round():
    TRACER.discard_round()


def current_trace_id() -> str | None:
    return TRACER.current_trace_id()


def configure(enabled: bool | None = None, dump_dir: str | None = None,
              capacity: int | None = None, dump_all: bool | None = None):
    """Mutate the process tracer/recorder in place (tests, perf harness,
    __main__ flag wiring). Returns (TRACER, RECORDER)."""
    if enabled is not None:
        TRACER.enabled = enabled
    RECORDER.configure(dump_dir=dump_dir, capacity=capacity,
                       dump_all=dump_all)
    return TRACER, RECORDER


def reset():
    """Restore env defaults and clear the ring + this thread's stack
    (test isolation). Also clears the decision ledger — its streak state
    feeds anomalies into rounds this tracer records, so the two must
    reset together or a prior test's held rung leaks a regression."""
    TRACER.enabled = _env_enabled()
    TRACER._tls.trace = None
    TRACER._tls.stack = []
    RECORDER.configure(dump_dir=_env_dir(), capacity=_env_capacity(),
                       dump_all=_env_dump_all())
    RECORDER.clear()
    from karpenter_tpu_torch.obs import capsule as _capsule
    from karpenter_tpu_torch.obs import decisions as _decisions
    from karpenter_tpu_torch.obs import timeline as _timeline

    _capsule.reset()
    _decisions.reset()
    _timeline.reset()
    return TRACER, RECORDER


# trace ids thread into the structured logging plane: every record emitted
# while a round is open carries trace=<id> (operator/logging.py providers).
# Installed lazily at the first round — importing the operator package here
# would close an import cycle (operator.__init__ → environment →
# provisioner → models.solver → obs)
def _log_context() -> dict:
    tid = TRACER.current_trace_id()
    return {"trace": tid} if tid else {}


_LOG_HOOK_INSTALLED: list = []


def _ensure_log_context():
    if _LOG_HOOK_INSTALLED:
        return
    _LOG_HOOK_INSTALLED.append(True)
    from karpenter_tpu_torch.operator import logging as _logging

    _logging.add_context_provider(_log_context)
