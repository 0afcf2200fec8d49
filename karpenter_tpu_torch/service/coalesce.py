"""Request coalescing for the solver fleet service.

The port's copy of ``karpenter_tpu/service/coalesce.py`` (imports
changed). Concurrent tenants' solves amortize the device only if they
share shape families and ride batched dispatches. This module is that
fold: a short-window batcher keyed on the pow-2 shape bucket plus the
static solve params — exactly the identity the compile ledger keys on —
so same-shape solves stack on a batch axis and ride ONE dispatch on the
card (:func:`karpenter_tpu_torch.models.solver.batched_invoke`), demuxed
per tenant on return.

Mechanics: the first request of a bucket becomes the *leader*, sleeps the
coalescing window (``KARPENTER_COALESCE_WINDOW_MS``), then dispatches every
request that joined; followers block on the bucket's event. A bucket that
reaches ``KARPENTER_COALESCE_MAX`` closes so later arrivals start a fresh
one (its leader runs its own window). A single-member bucket dispatches
through the ordinary per-request path — native routing and all — so
coalescing can only ever ADD batch-mates, never change a lone solve's
engine. Batch shape lands on
``karpenter_solver_coalesce_batch_size``; requests that shared a dispatch
count on ``karpenter_solver_coalesced_requests_total``.
"""

from __future__ import annotations

import threading
import time

__all__ = ["Coalescer", "coalesce_window_s"]


def coalesce_window_s() -> float:
    """KARPENTER_COALESCE_WINDOW_MS: the fold window in ms (0 disables
    coalescing entirely — every request dispatches alone)."""
    from karpenter_tpu_torch.service.session import env_float

    return env_float("KARPENTER_COALESCE_WINDOW_MS", 0.0,
                     minimum=0.0) / 1000.0


def _env_max_batch() -> int:
    from karpenter_tpu_torch.service.session import env_int

    return env_int("KARPENTER_COALESCE_MAX", 8, minimum=1)


class _Bucket:
    __slots__ = ("items", "results", "error", "done", "closed")

    def __init__(self):
        self.items: list = []
        self.results = None
        self.error = None
        self.done = threading.Event()
        self.closed = False


class Coalescer:
    """Fold same-bucket concurrent solves into one dispatch.

    ``dispatch_one(args)`` runs a lone solve through the ordinary path;
    ``dispatch_many(args_list)`` runs a stacked batch and returns one
    result per input, order-preserving."""

    def __init__(self, dispatch_one, dispatch_many, window_s: float,
                 max_batch: int | None = None, registry=None):
        self._dispatch_one = dispatch_one
        self._dispatch_many = dispatch_many
        self.window_s = window_s
        self.max_batch = max_batch if max_batch is not None else _env_max_batch()
        self._registry = registry
        self._lock = threading.Lock()
        self._buckets: dict = {}  # bucket key -> open _Bucket

    def submit(self, key, args):
        """Solve ``args`` inside the ``key`` bucket; blocks until the
        bucket's dispatch returns and yields this request's result."""
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None or bucket.closed:
                bucket = _Bucket()
                self._buckets[key] = bucket
                leader = True
            else:
                leader = False
            idx = len(bucket.items)
            bucket.items.append(args)
            if len(bucket.items) >= self.max_batch:
                bucket.closed = True
                if self._buckets.get(key) is bucket:
                    del self._buckets[key]
        if leader:
            self._lead(key, bucket)
            bucket.done.wait()
        else:
            # spans are thread-local, so the batch's solve.kernel leaf
            # lands only in the LEADER's round trace; followers open a
            # device-kind wait leaf in their OWN linked round so a grep
            # by their client's trace id still finds where the request's
            # device time went (and to which batch it folded)
            from karpenter_tpu_torch import obs

            with obs.span("solve.coalesce_wait", kind="device") as sp:
                bucket.done.wait()
                if sp is not None:
                    if sp.attrs is None:
                        sp.attrs = {}
                    sp.attrs["batch"] = len(bucket.items)
        if bucket.error is not None:
            raise bucket.error
        return bucket.results[idx]

    def _lead(self, key, bucket: _Bucket):
        # the window is the fold opportunity: followers join while the
        # leader sleeps. A full bucket already closed itself; the sleep
        # still runs (bounded, a few ms) — simplicity over the last ms.
        if self.window_s > 0:
            time.sleep(self.window_s)
        with self._lock:
            bucket.closed = True
            if self._buckets.get(key) is bucket:
                del self._buckets[key]
            items = list(bucket.items)
        try:
            self._observe(len(items))
            if len(items) == 1:
                bucket.results = [self._dispatch_one(items[0])]
            else:
                bucket.results = self._dispatch_many(items)
        except Exception as e:  # propagated to every member
            bucket.error = e
        finally:
            bucket.done.set()

    def _observe(self, n: int):
        if self._registry is None:
            return
        from karpenter_tpu_torch.operator import metrics as m

        self._registry.histogram(
            m.SOLVER_COALESCE_BATCH,
            "requests folded per coalesced dispatch window",
            buckets=m.SOLVER_COALESCE_BUCKETS,
        ).observe(n)
        if n > 1:
            self._registry.counter(
                m.SOLVER_COALESCED,
                "requests that shared a coalesced device dispatch",
            ).inc(n)
