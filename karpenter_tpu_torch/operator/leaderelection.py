"""Lease-based leader election — the controller-runtime analog.

The reference operator runs with leader election on a coordination.k8s.io
Lease (pkg/operator/operator.go NewOperator: LeaderElection enabled,
LeaderElectionID "karpenter-leader-election"): only the lease holder runs
controllers; standbys poll and take over when the lease expires. The
hermetic build elects through the store's "leases" kind with the same
acquire/renew/release protocol so multi-instance deployments (or tests)
get single-writer semantics.

The port's copy of ``karpenter_tpu/operator/leaderelection.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.api.objects import ObjectMeta

LEASE_NAME = "karpenter-leader-election"
LEASE_DURATION = 15.0  # controller-runtime defaults
RENEW_DEADLINE = 10.0
RETRY_PERIOD = 2.0


class _Lease:
    def __init__(self, name, holder, acquired, renewed, duration):
        self.metadata = ObjectMeta(name=name, namespace="kube-system")
        self.holder = holder
        self.acquired = acquired
        self.renewed = renewed
        self.duration = duration


class LeaderElector:
    def __init__(self, store, identity: str, clock=None,
                 lease_duration: float = LEASE_DURATION):
        from karpenter_tpu_torch.utils.clock import Clock

        self.store = store
        self.identity = identity
        self.clock = clock or Clock()
        self.lease_duration = lease_duration

    def _lease(self):
        return self.store.try_get("leases", LEASE_NAME, namespace="kube-system")

    def is_leader(self) -> bool:
        lease = self._lease()
        return (
            lease is not None
            and lease.holder == self.identity
            and self.clock.now() - lease.renewed < self.lease_duration
        )

    # whether the most recent successful try_acquire TOOK the lease
    # (first creation, or expiry takeover from another holder) rather
    # than renewing this identity's own: only a real takeover requires
    # the informer-cache resync — the store's watch queue is
    # single-consumer and only the leader drains it, so a leader
    # re-acquiring its OWN stale lease (a fake-clock jump, a long GC
    # pause with no contender) has missed nothing, and resyncing there
    # would needlessly journal an opaque consolidation bump every time
    # the clock outruns the lease duration
    last_acquire_takeover: bool = False

    def try_acquire(self) -> bool:
        """Acquire or renew; True iff this identity holds the lease after
        the call (leaderelection.go tryAcquireOrRenew)."""
        now = self.clock.now()
        lease = self._lease()
        if lease is None:
            lease = _Lease(LEASE_NAME, self.identity, now, now, self.lease_duration)
            try:
                self.store.create("leases", lease)
            except Exception:
                return self.is_leader()  # lost the race
            self.last_acquire_takeover = True
            return True
        expired = now - lease.renewed >= lease.duration
        if lease.holder == self.identity:
            # renew at most once per RETRY_PERIOD: an update per reconcile
            # round would flood the watch stream (and read as progress to
            # idle detection). Renewing our OWN lease — even one the clock
            # let expire — is not a takeover: the holder never changed, so
            # no other instance can have drained the event queue meanwhile
            self.last_acquire_takeover = False
            if now - lease.renewed >= RETRY_PERIOD:
                lease.renewed = now
                self.store.update("leases", lease)
            return True
        if expired:
            lease.holder = self.identity
            lease.acquired = now
            lease.renewed = now
            self.store.update("leases", lease)
            self.last_acquire_takeover = True
            return True
        return False

    def release(self):
        """Voluntary hand-off on shutdown (releaseOnCancel)."""
        lease = self._lease()
        if lease is not None and lease.holder == self.identity:
            # expire relative to NOW — an absolute 0.0 only reads as
            # expired once the clock has advanced past the duration
            lease.renewed = self.clock.now() - lease.duration
            self.store.update("leases", lease)
