"""Per-tenant sessions for the multi-tenant solver fleet service.

The port's copy of ``karpenter_tpu/service/session.py`` (imports
changed). The streaming delta protocol's server half (the JAX package's
deploy/README.md "Multi-tenant solver service"): a tenant registers a session, ships ONE full tensor
snapshot, then ships per-round deltas — changed arrays, plus row-splices
for arrays whose leading axis moved sparsely — and the server maintains
the solve-ready bundle per session. Patching reuses the SAME in-place row
semantics the in-process disruption snapshot uses
(:func:`karpenter_tpu_torch.ops.tensorize.splice_rows`, the primitive
``ExistingSnapshot.apply_delta`` splices dirty existing-node rows with),
so a delta-advanced server bundle is bit-identical to a full upload by
construction — ``tests/test_torch_service.py`` pins it against the JAX
package's server.

Protocol invariants enforced here, each with its own exception class (the
gRPC layer maps the class name into the status details, which the client's
fallback/resync logic and the ``reason`` metric label key on):

- **OutOfOrderDelta** — a request's ``seq`` must strictly increase per
  session; replays and reordered retries are rejected, never applied.
- **ResyncRequired** — a delta whose ``base_seq`` does not match the
  session's last applied seq (journal gap), whose journal window carries
  an opaque (null) entry, whose patch shapes mismatch the cached family,
  or that arrives after the session's bundle was evicted. The client
  answers with one full re-upload.
- **SessionExpired / UnknownSession** — the TTL reaper dropped the
  session (or it never existed); the client re-registers and re-ships a
  full snapshot.
- **TenantBudgetExceeded** — admission control: each tenant holds at most
  ``KARPENTER_TENANT_INFLIGHT`` requests in flight; excess is rejected as
  backpressure instead of queueing without bound.
- **CrossTenantBleed** — the isolation assertion hook: every cached
  bundle is tagged with its owner tenant and every patch re-checks the
  tag. A mismatch aborts the request, fires the ``cross-tenant-bleed``
  anomaly (the flight recorder dumps the round), and lands on
  ``karpenter_solver_bleed_checks_total{outcome="bleed"}`` — the scrape
  must never show a bleed check silently passing over corrupt state.

Cache economics: bundles live under one LRU byte budget
(``KARPENTER_SESSION_CACHE_BYTES``) across all sessions; eviction drops
the least-recently-used OTHER session's bundle (never the one being
written) and is visible on
``karpenter_solver_session_cache_evictions_total`` plus the
``karpenter_solver_session_cache_bytes`` gauge — a fleet whose tenants
thrash each other's snapshots shows up on the scrape, not as mystery
resyncs.

Expiry is enforced twice: reap-on-access (``lookup``/``register``) and a
periodic **sweep** (:meth:`SessionRegistry.sweep`, run by the service's
sweeper thread every ``KARPENTER_SESSION_SWEEP_S``) that reaps idle
expired sessions and releases their bundle bytes without any client
touching the server — counted on
``karpenter_solver_session_sweeps_total``.
"""

from __future__ import annotations

import threading
import time
import uuid
from contextlib import contextmanager

import numpy as np

from karpenter_tpu_torch.ops.tensorize import splice_rows

__all__ = [
    "SessionRegistry",
    "TenantSession",
    "SessionError",
    "UnknownSession",
    "SessionExpired",
    "ResyncRequired",
    "OutOfOrderDelta",
    "TenantBudgetExceeded",
    "CrossTenantBleed",
    "ROWS_SUFFIX",
    "VALS_SUFFIX",
    "env_int",
    "env_float",
    "env_bool",
]

# wire names of a row-spliced delta entry: "<key>//rows" carries the row
# indices, "<key>//vals" the replacement rows ("//" cannot appear in a
# kernel-arg name)
ROWS_SUFFIX = "//rows"
VALS_SUFFIX = "//vals"


class SessionError(Exception):
    """Base of every protocol rejection; ``status`` names the gRPC code
    the service maps it to (resolved there — this module stays
    grpc-free)."""

    status = "FAILED_PRECONDITION"


class UnknownSession(SessionError):
    status = "FAILED_PRECONDITION"


class SessionExpired(SessionError):
    status = "FAILED_PRECONDITION"


class ResyncRequired(SessionError):
    status = "FAILED_PRECONDITION"


class OutOfOrderDelta(SessionError):
    status = "INVALID_ARGUMENT"


class TenantBudgetExceeded(SessionError):
    status = "RESOURCE_EXHAUSTED"


class CrossTenantBleed(SessionError):
    status = "INTERNAL"


# the ONE env-knob parser trio, hoisted to utils/envknobs.py when the
# decision ledger needed the same semantics below the service layer;
# re-exported here so every existing importer (coalesce, solver_service,
# perf, bench) keeps its spelling
from karpenter_tpu_torch.utils.envknobs import env_bool, env_float, env_int  # noqa: E402,F401


class TenantSession:
    """One tenant's registered stream: seq fencing state plus the cached
    solve bundle. Mutated only under the owning registry's lock."""

    def __init__(self, session_id: str, tenant: str, now: float):
        self.id = session_id
        self.tenant = tenant
        self.created = now
        self.last_used = now
        self.last_seq = 0  # highest applied request seq (0 = nothing yet)
        self.bundle: dict | None = None  # solve-ready kernel args
        self.bundle_tenant: str | None = None  # isolation tag
        self.bundle_bytes = 0
        # accounting the perf row reads back through response meta
        self.full_uploads = 0
        self.delta_rounds = 0


def _nbytes(arrays: dict) -> int:
    return int(sum(np.asarray(v).nbytes for v in arrays.values()))


class SessionRegistry:
    """All live tenant sessions of one server, plus the shared LRU byte
    budget and the per-tenant admission budget."""

    def __init__(self, byte_budget: int | None = None,
                 ttl_s: float | None = None,
                 inflight_budget: int | None = None,
                 now=time.monotonic):
        self.byte_budget = (
            byte_budget if byte_budget is not None
            else env_int("KARPENTER_SESSION_CACHE_BYTES", 1 << 30)
        )
        self.ttl_s = (
            ttl_s if ttl_s is not None
            else env_float("KARPENTER_SESSION_TTL_S", 900.0)
        )
        self.inflight_budget = (
            inflight_budget if inflight_budget is not None
            else env_int("KARPENTER_TENANT_INFLIGHT", 4)
        )
        # hard cap on live sessions: tenant ids and Register calls are
        # client-supplied, so a flapping client re-registering per solve
        # must not grow _sessions unbounded for a full TTL (the same
        # bounded-memory stance as the SloTracker tenant cap and the
        # in-flight pop-on-drain); past the cap the LRU session is
        # dropped and its owner resyncs
        self.session_cap = env_int("KARPENTER_SESSION_MAX", 4096,
                                   minimum=1)
        self._now = now
        self._lock = threading.Lock()
        self._sessions: dict = {}  # session id -> TenantSession
        self._inflight: dict = {}  # tenant -> in-flight request count
        self._total_bytes = 0
        self._evictions_pending: list = []  # tenants evicted by last store

    # -- lifecycle -------------------------------------------------------

    def register(self, tenant: str, registry=None) -> TenantSession:
        if not tenant:
            raise ValueError("tenant id must be non-empty")
        now = self._now()
        sess = TenantSession(f"s-{uuid.uuid4().hex[:16]}", tenant, now)
        with self._lock:
            self._reap(now)
            while len(self._sessions) >= self.session_cap:
                lru = min(self._sessions.values(),
                          key=lambda s: s.last_used)
                self._drop(lru)
            self._sessions[sess.id] = sess
            count = len(self._sessions)
        self._metric_gauge(registry, count)
        return sess

    def release(self, session_id: str, tenant: str, registry=None) -> bool:
        """Drop an abandoned session NOW (the Register `supersedes` path)
        instead of letting its bundle squat in the LRU byte budget until
        the TTL reaper. Tenant-checked: a client can only release its own
        sessions. Unknown/already-reaped ids are a no-op."""
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is None or sess.tenant != tenant:
                return False
            self._drop(sess)
            count = len(self._sessions)
        self._metric_gauge(registry, count)
        return True

    def lookup(self, session_id: str, registry=None) -> TenantSession:
        now = self._now()
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is not None and now - sess.last_used > self.ttl_s:
                self._drop(sess)
                sess = None
                expired = True
            else:
                expired = False
            count = len(self._sessions)
        if sess is None:
            self._metric_gauge(registry, count)
            if expired:
                raise SessionExpired(f"session {session_id} expired "
                                     f"(ttl {self.ttl_s:.0f}s)")
            raise UnknownSession(f"session {session_id} is not registered")
        return sess

    def _reap(self, now: float):
        # caller holds the lock
        dead = [s for s in self._sessions.values()
                if now - s.last_used > self.ttl_s]
        for s in dead:
            self._drop(s)

    def sweep(self, registry=None) -> int:
        """One GC sweep: reap every expired session and release its bundle
        bytes from the LRU budget NOW, instead of waiting for some client
        access to trip the reap-on-access path — an idle expired tenant's
        multi-MB bundle must not squat the shared budget (evicting healthy
        tenants) just because nobody happened to touch the server. Counts
        ``karpenter_solver_session_sweeps_total`` and refreshes the
        session/bytes gauges; returns the number of sessions reaped."""
        with self._lock:
            before = len(self._sessions)
            self._reap(self._now())
            count = len(self._sessions)
            total = self._total_bytes
        reaped = before - count
        if registry is not None:
            from karpenter_tpu_torch.operator import metrics as m

            registry.counter(
                m.SOLVER_SESSION_SWEEPS,
                "periodic session-GC sweeps (expired sessions reaped and "
                "their bundle bytes released without a client access)",
            ).inc()
            registry.gauge(
                m.SOLVER_SESSIONS,
                "live tenant sessions on this solver service",
            ).set(count)
            registry.gauge(
                m.SOLVER_SESSION_CACHE_BYTES,
                "bytes of cached per-tenant solve bundles (LRU budget "
                "KARPENTER_SESSION_CACHE_BYTES)",
            ).set(total)
        return reaped

    def start_sweeper(self, interval_s: float | None = None, registry=None):
        """Run :meth:`sweep` every ``interval_s`` seconds (default
        ``KARPENTER_SESSION_SWEEP_S``, 60; <= 0 disables) on a daemon
        thread. Returns a ``threading.Event`` — set it to stop the
        sweeper — or None when disabled."""
        if interval_s is None:
            interval_s = env_float("KARPENTER_SESSION_SWEEP_S", 60.0)
        if interval_s <= 0:
            return None
        stop = threading.Event()

        def _loop():
            while not stop.wait(interval_s):
                self.sweep(registry=registry)

        t = threading.Thread(target=_loop, name="session-sweeper",
                             daemon=True)
        t.start()
        return stop

    def _drop(self, sess: TenantSession):
        # caller holds the lock
        self._sessions.pop(sess.id, None)
        if sess.bundle is not None:
            self._total_bytes -= sess.bundle_bytes
            sess.bundle = None
            sess.bundle_bytes = 0

    # -- admission (per-tenant in-flight budget) -------------------------

    @contextmanager
    def admit(self, sess: TenantSession, registry=None):
        with self._lock:
            n = self._inflight.get(sess.tenant, 0)
            if n >= self.inflight_budget:
                ok = False
            else:
                ok = True
                self._inflight[sess.tenant] = n + 1
        if not ok:
            if registry is not None:
                from karpenter_tpu_torch.operator import metrics as m

                registry.counter(
                    m.SOLVER_ADMISSION_REJECTS,
                    "session solves rejected by the per-tenant in-flight "
                    "budget (backpressure, not queueing)",
                ).inc(tenant=sess.tenant)
            raise TenantBudgetExceeded(
                f"tenant {sess.tenant} already has {self.inflight_budget} "
                "solves in flight")
        try:
            yield
        finally:
            with self._lock:
                left = self._inflight.get(sess.tenant, 1) - 1
                if left <= 0:
                    # drop drained entries: tenant ids are client-supplied,
                    # and name churn must not grow this dict forever (the
                    # same stance as the SloTracker tenant cap)
                    self._inflight.pop(sess.tenant, None)
                else:
                    self._inflight[sess.tenant] = left

    # -- snapshot bundle maintenance -------------------------------------

    def apply(self, sess: TenantSession, arrays: dict, meta: dict,
              registry=None) -> dict:
        """Fence the request and produce the solve-ready args: a full
        upload replaces the session's bundle; a delta builds a PATCHED
        COPY and swaps it in under a fence re-check (swap-not-mutate: a
        dispatch already queued on the previous bundle — possibly parked
        in the coalescer window — never observes a membership or array
        change, and the expensive numpy work runs outside the registry
        lock so other tenants' requests don't serialize behind it).
        Raises a :class:`SessionError` subclass on every protocol
        violation (module docstring)."""
        seq = int(meta.get("seq", 0))
        mode = meta.get("mode", "full")
        now = self._now()
        if mode != "delta":
            # multi-MB conversion + byte sweep OUTSIDE the lock: holding
            # it here would serialize every other tenant's lookup/admit
            # behind each snapshot copy — inflating exactly the
            # cross-tenant p99 this service exists to bound
            full_args = {k: np.asarray(v) for k, v in arrays.items()}
            full_bytes = _nbytes(full_args)
            with self._lock:
                if self._sessions.get(sess.id) is not sess:
                    # dropped while the conversion ran unlocked (TTL reap,
                    # session-cap LRU, supersedes release): storing onto
                    # the orphan would add bytes _collect_evictions can
                    # never see again — permanent phantom budget pressure
                    raise SessionExpired(
                        f"session {sess.id} dropped during a full upload")
                if seq <= sess.last_seq:
                    raise OutOfOrderDelta(
                        f"seq {seq} <= last applied {sess.last_seq} for "
                        f"session {sess.id}")
                args = full_args
                self._store(sess, full_args, full_bytes)
                sess.full_uploads += 1
                hit_kind = None
                sess.last_seq = seq
                sess.last_used = now
                total = self._total_bytes
        else:
            with self._lock:
                if seq <= sess.last_seq:
                    raise OutOfOrderDelta(
                        f"seq {seq} <= last applied {sess.last_seq} for "
                        f"session {sess.id}")
                self._check_delta(sess, meta)
                self._bleed_check(sess, registry)
                base = sess.bundle
                base_seq = sess.last_seq
            # the splice copies happen UNLOCKED against the grabbed
            # reference; the swap below re-checks the fence, so a
            # concurrent apply on the same session (already a protocol
            # violation) resolves to a resync demand, never corruption
            args = self._build_patched(base, arrays, meta)
            with self._lock:
                if sess.last_seq != base_seq or sess.bundle is not base:
                    raise ResyncRequired(
                        f"session {sess.id} mutated concurrently with a "
                        "delta apply")
                sess.bundle = args
                sess.delta_rounds += 1
                hit_kind = "delta"
                sess.last_seq = seq
                sess.last_used = now
                total = self._total_bytes
        if registry is not None:
            from karpenter_tpu_torch.operator import metrics as m

            if hit_kind is not None:
                registry.counter(
                    m.SOLVER_SESSION_CACHE_HITS,
                    "session solves served by patching the cached "
                    "per-tenant bundle (deltas, not re-uploads)",
                ).inc(tenant=sess.tenant, kind=hit_kind)
            else:
                registry.counter(
                    m.SOLVER_SESSION_CACHE_STORES,
                    "full snapshot uploads stored into the per-tenant "
                    "bundle cache",
                ).inc(tenant=sess.tenant)
            registry.gauge(
                m.SOLVER_SESSION_CACHE_BYTES,
                "bytes of cached per-tenant solve bundles (LRU budget "
                "KARPENTER_SESSION_CACHE_BYTES)",
            ).set(total)
        return args

    def _check_delta(self, sess: TenantSession, meta: dict):
        # caller holds the lock
        if sess.bundle is None:
            raise ResyncRequired(
                f"session {sess.id} holds no bundle (evicted or never "
                "uploaded)")
        base_seq = int(meta.get("base_seq", -1))
        if base_seq != sess.last_seq:
            raise ResyncRequired(
                f"delta base seq {base_seq} != last applied "
                f"{sess.last_seq} (journal gap)")
        journal = meta.get("journal")
        if journal is not None and any(e is None for e in journal):
            raise ResyncRequired("opaque journal entry in the delta window")

    def _bleed_check(self, sess: TenantSession, registry=None):
        """The cross-tenant-bleed assertion hook: the cached bundle's
        owner tag must match the session about to consume it."""
        ok = sess.bundle_tenant == sess.tenant
        if registry is not None:
            from karpenter_tpu_torch.operator import metrics as m

            registry.counter(
                m.SOLVER_BLEED_CHECKS,
                "cross-tenant isolation assertions on cached bundles",
            ).inc(outcome="ok" if ok else "bleed")
        if not ok:
            from karpenter_tpu_torch import obs

            obs.anomaly("cross-tenant-bleed", registry=registry,
                        tenant=sess.tenant,
                        bundle_tenant=str(sess.bundle_tenant))
            raise CrossTenantBleed(
                f"bundle tagged {sess.bundle_tenant!r} consumed by tenant "
                f"{sess.tenant!r}")
        return True

    @staticmethod
    def _build_patched(base: dict, arrays: dict, meta: dict) -> dict:
        """Patched bundle copy — pure, lock-free: the result is a NEW dict
        (unchanged keys share arrays; patched keys get spliced copies), so
        the previous bundle any in-flight dispatch holds stays
        bit-identical and membership-stable."""
        bundle = dict(base)
        patch = meta.get("patch") or {}
        for key, kind in patch.items():
            if kind == "rows":
                rows = arrays.get(key + ROWS_SUFFIX)
                vals = arrays.get(key + VALS_SUFFIX)
                old = bundle.get(key)
                if rows is None or vals is None or old is None:
                    raise ResyncRequired(f"row patch for {key} is missing "
                                         "its rows/vals/base")
                rows = np.asarray(rows)
                # negative indices would wrap silently and splice the
                # WRONG rows — reject both directions, never corrupt
                if rows.size and (int(rows.min()) < 0
                                  or int(rows.max()) >= old.shape[0]):
                    raise ResyncRequired(
                        f"row patch for {key} addresses rows outside "
                        f"[0, {old.shape[0]})")
                new = old.copy()
                try:
                    splice_rows(new, rows, np.asarray(vals))
                except ValueError as e:
                    raise ResyncRequired(str(e)) from e
                bundle[key] = new
            else:  # full replacement of one array
                val = arrays.get(key)
                old = bundle.get(key)
                if val is None:
                    raise ResyncRequired(f"replacement for {key} missing")
                val = np.asarray(val)
                if old is not None and (old.shape != val.shape
                                        or old.dtype != val.dtype):
                    raise ResyncRequired(
                        f"replacement for {key} changes the compiled "
                        f"family ({old.shape}/{old.dtype} -> "
                        f"{val.shape}/{val.dtype})")
                if old is None:
                    raise ResyncRequired(
                        f"replacement for {key} has no cached base")
                bundle[key] = val
        # shape-stable patches cannot change a bundle's size (key-set
        # changes go through a full re-upload — the client's shape-change
        # resync), so the byte accounting is invariant across deltas
        return bundle

    def _store(self, sess: TenantSession, args: dict, nbytes: int):
        # caller holds the lock; `nbytes` was computed outside it
        self._total_bytes -= sess.bundle_bytes
        sess.bundle = args
        sess.bundle_tenant = sess.tenant
        sess.bundle_bytes = nbytes
        self._total_bytes += sess.bundle_bytes
        # EXTEND, never replace: a concurrent store's victims must not be
        # lost before drain_evictions counts them onto the scrape
        self._evictions_pending.extend(self._collect_evictions(sess))

    def _collect_evictions(self, keep: TenantSession) -> list:
        # caller holds the lock; evicts oldest-last_used OTHER bundles
        # until the byte budget holds (the writer's own bundle survives)
        evicted = []
        while self._total_bytes > self.byte_budget:
            victims = [
                s for s in self._sessions.values()
                if s.bundle is not None and s is not keep
            ]
            if not victims:
                break
            victim = min(victims, key=lambda s: s.last_used)
            self._total_bytes -= victim.bundle_bytes
            victim.bundle = None
            victim.bundle_tenant = None
            victim.bundle_bytes = 0
            evicted.append(victim.tenant)
        return evicted

    def drain_evictions(self, registry=None) -> list:
        """Evicted-tenant list of the most recent store, counted onto the
        scrape (called by the service after releasing no locks of its
        own)."""
        with self._lock:
            evicted, self._evictions_pending = self._evictions_pending, []
        if evicted and registry is not None:
            from karpenter_tpu_torch.operator import metrics as m

            c = registry.counter(
                m.SOLVER_SESSION_CACHE_EVICTIONS,
                "per-tenant bundles evicted by the LRU byte budget",
            )
            for tenant in evicted:
                c.inc(tenant=tenant)
        return evicted

    def verify_isolation(self, registry=None) -> list:
        """Sweep every live bundle's tenant tag (the test/perf-facing
        bleed hook); returns the list of violating session ids (empty =
        clean) and counts each check on the scrape."""
        with self._lock:
            pairs = [
                (s.id, s.tenant, s.bundle_tenant)
                for s in self._sessions.values()
                if s.bundle is not None
            ]
        bad = []
        if registry is not None:
            from karpenter_tpu_torch.operator import metrics as m

            c = registry.counter(
                m.SOLVER_BLEED_CHECKS,
                "cross-tenant isolation assertions on cached bundles",
            )
        for sid, tenant, tag in pairs:
            ok = tenant == tag
            if registry is not None:
                c.inc(outcome="ok" if ok else "bleed")
            if not ok:
                bad.append(sid)
        return bad

    # -- introspection ---------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            sessions = list(self._sessions.values())
            total = self._total_bytes
        return {
            "sessions": len(sessions),
            "bytes": total,
            "byte_budget": self.byte_budget,
            "tenants": sorted({s.tenant for s in sessions}),
            "full_uploads": sum(s.full_uploads for s in sessions),
            "delta_rounds": sum(s.delta_rounds for s in sessions),
        }

    def _metric_gauge(self, registry, count: int):
        if registry is None:
            return
        from karpenter_tpu_torch.operator import metrics as m

        registry.gauge(
            m.SOLVER_SESSIONS, "live tenant sessions on this solver service",
        ).set(count)
