"""In-memory apiserver: the envtest/kwok analog.

The reference's entire backend is client-go ↔ kube-apiserver (SURVEY.md §5
"distributed communication backend"): watch streams, finalizer-gated
deletion, the Eviction subresource, and leases. This store provides those
semantics in-process so the full controller ring runs hermetically — the
same role envtest (pkg/test/environment.go) plays for the reference's tier-1
suites and kwok for its e2e tier.

Semantics implemented:
- resourceVersion bump per mutation, with optimistic concurrency on
  update: a caller writing from a detached copy whose resourceVersion is
  stale gets ConflictError (apiserver 409). The synchronous controller
  ring aliases the stored instances — those writes always carry the
  current version — so today's controllers never conflict; the check
  guards any future concurrent worker or remote client
  (kube/client.py retry_on_conflict is the retry pattern)
- deletion with finalizers: delete stamps deletion_timestamp; the object
  disappears only when its finalizer list empties
- watch events queued per mutation, drained by the controller manager
- pod Eviction subresource honoring PDB disruptionsAllowed (429 analog)
- pod binding (pod.node_name immutable once set)

The port's copy of ``karpenter_tpu/kube/store.py`` (imports changed).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from karpenter_tpu_torch.api.objects import ObjectMeta, PodDisruptionBudget
from karpenter_tpu_torch.kube.client import KubeClient


class NotFoundError(Exception):
    pass


class ConflictError(Exception):
    pass


class StaleVersionError(ConflictError):
    """Optimistic-concurrency conflict (apiserver 409 on a stale
    resourceVersion) — the only ConflictError a re-read can cure, and the
    only one retry_on_conflict retries (client-go retry.RetryOnConflict)."""


class TooManyRequests(Exception):
    """Eviction blocked by a PodDisruptionBudget (HTTP 429 analog)."""


@dataclass
class Event:
    kind: str
    type: str  # Added | Modified | Deleted
    obj: object = None


# kinds are plural lowercase, mirroring rest paths
KINDS = (
    "pods",
    "nodes",
    "nodepools",
    "nodeclaims",
    "daemonsets",
    "deployments",
    "pdbs",
    "pvcs",
    "pvs",
    "storageclasses",
    "volumeattachments",
    "namespaces",
    "leases",
    "events",
    "nodeclasses",
    "priorityclasses",
)

_NAMESPACED = {"pods", "daemonsets", "deployments", "pdbs", "pvcs", "leases", "events"}


def _key(kind: str, obj) -> str:
    meta = obj.metadata
    return f"{meta.namespace}/{meta.name}" if kind in _NAMESPACED else meta.name


class KubeStore(KubeClient):
    def __init__(self, clock=None):
        from karpenter_tpu_torch.utils.clock import Clock

        self.clock = clock or Clock()
        self._objects: dict = {k: {} for k in KINDS}
        self._rv = 0
        self._events: list = []
        self._lock = threading.RLock()

    # -- core CRUD -------------------------------------------------------
    def create(self, kind: str, obj):
        from karpenter_tpu_torch.api.admission import admit

        admit(kind, obj)  # webhook/CEL analog: reject illegal specs
        with self._lock:
            key = _key(kind, obj)
            if key in self._objects[kind]:
                raise ConflictError(f"{kind}/{key} already exists")
            self._rv += 1
            obj.metadata.resource_version = self._rv
            if not obj.metadata.creation_timestamp:
                obj.metadata.creation_timestamp = self.clock.now()
            self._objects[kind][key] = obj
            self._events.append(Event(kind, "Added", obj))
            return obj

    def get(self, kind: str, name: str, namespace: str = "default"):
        with self._lock:
            key = f"{namespace}/{name}" if kind in _NAMESPACED else name
            obj = self._objects[kind].get(key)
            if obj is None:
                raise NotFoundError(f"{kind}/{key}")
            return obj

    def try_get(self, kind: str, name: str, namespace: str = "default"):
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def update(self, kind: str, obj):
        from karpenter_tpu_torch.api.admission import admit

        admit(kind, obj)
        with self._lock:
            key = _key(kind, obj)
            stored = self._objects[kind].get(key)
            if stored is None:
                raise NotFoundError(f"{kind}/{key}")
            # optimistic concurrency (apiserver 409): a DETACHED copy must
            # carry the stored resourceVersion; the aliased instance is by
            # definition current
            if stored is not obj and obj.metadata.resource_version != (
                stored.metadata.resource_version
            ):
                raise StaleVersionError(
                    f"{kind}/{key}: stale resourceVersion "
                    f"{obj.metadata.resource_version} != {stored.metadata.resource_version}"
                )
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._objects[kind][key] = obj
            self._events.append(Event(kind, "Modified", obj))
            # finalizer-gated deletion completes on any update that empties
            # the finalizer list after deletion was requested
            self._maybe_finalize(kind, key, obj)
            return obj

    def delete(self, kind: str, obj_or_name, namespace: str = "default"):
        with self._lock:
            if isinstance(obj_or_name, str):
                obj = self.get(kind, obj_or_name, namespace)
            else:
                obj = obj_or_name
            key = _key(kind, obj)
            if key not in self._objects[kind]:
                raise NotFoundError(f"{kind}/{key}")
            if obj.metadata.deletion_timestamp is None:
                obj.metadata.deletion_timestamp = self.clock.now()
                self._rv += 1
                obj.metadata.resource_version = self._rv
                self._events.append(Event(kind, "Modified", obj))
            self._maybe_finalize(kind, key, obj)

    def _maybe_finalize(self, kind: str, key: str, obj):
        if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
            del self._objects[kind][key]
            self._events.append(Event(kind, "Deleted", obj))

    def list(self, kind: str, namespace: str | None = None, predicate=None) -> list:
        with self._lock:
            out = list(self._objects[kind].values())
        if namespace is not None:
            out = [o for o in out if o.metadata.namespace == namespace]
        if predicate is not None:
            out = [o for o in out if predicate(o)]
        return out

    # -- watch -----------------------------------------------------------
    def drain_events(self) -> list:
        with self._lock:
            events, self._events = self._events, []
            return events

    # -- pod subresources ------------------------------------------------
    def bind(self, pod, node_name: str):
        with self._lock:
            if pod.node_name and pod.node_name != node_name:
                raise ConflictError(f"pod {pod.key()} already bound to {pod.node_name}")
            pod.node_name = node_name
            pod.phase = "Running"
            self.update("pods", pod)

    def evict(self, pod):
        """Eviction subresource: PDB-gated delete (the reference's terminator
        drives this API, terminator/eviction.go:129-193)."""
        with self._lock:
            for pdb in self.list("pdbs", namespace=pod.namespace):
                if pdb.selector is not None and pdb.selector.matches(pod.metadata.labels):
                    if self._disruptions_allowed(pdb) <= 0:
                        raise TooManyRequests(
                            f"eviction of {pod.key()} blocked by pdb {pdb.metadata.name}"
                        )
            self.delete("pods", pod)

    def evict_wave(self, pods):
        """One PDB-checked eviction WAVE: the batched form of
        :meth:`evict` the drain orchestration uses (node termination
        drains whole command waves — thousands of pods — and per-pod
        ``evict`` recomputes every matching PDB's allowance from a full
        pod-list scan each time). Returns ``(evicted, blocked)`` lists.

        Semantics are EXACTLY sequential ``evict`` calls in ``pods``
        order: each pod's check sees every earlier deletion of the wave.
        The batching is pure memoization — a PDB's allowance is computed
        once and reused until a pod MATCHING that PDB is deleted (only a
        matching pod's deletion can move its counts), then lazily
        recomputed; the lock is held across the wave, so the PDB set
        itself cannot change mid-wave."""
        evicted, blocked = [], []
        with self._lock:
            pdbs_by_ns: dict = {}
            allowance: dict = {}  # (ns, pdb name) -> disruptions allowed
            for pod in pods:
                ns = pod.namespace
                pdbs = pdbs_by_ns.get(ns)
                if pdbs is None:
                    pdbs = pdbs_by_ns[ns] = [
                        pdb for pdb in self.list("pdbs", namespace=ns)
                        if pdb.selector is not None
                    ]
                matching = [
                    pdb for pdb in pdbs
                    if pdb.selector.matches(pod.metadata.labels)
                ]
                allowed = True
                for pdb in matching:
                    key = (ns, pdb.metadata.name)
                    a = allowance.get(key)
                    if a is None:
                        a = allowance[key] = self._disruptions_allowed(pdb)
                    if a <= 0:
                        allowed = False
                        break
                if not allowed:
                    blocked.append(pod)
                    continue
                self.delete("pods", pod)
                for pdb in matching:
                    # a matching pod left the pod set: the memoized
                    # allowance is stale — recompute on next sight
                    allowance.pop((ns, pdb.metadata.name), None)
                evicted.append(pod)
        return evicted, blocked

    def _disruptions_allowed(self, pdb: PodDisruptionBudget) -> int:
        pods = [
            p
            for p in self.list("pods", namespace=pdb.metadata.namespace)
            if pdb.selector.matches(p.metadata.labels) and p.metadata.deletion_timestamp is None
        ]
        healthy = sum(1 for p in pods if p.phase == "Running")
        if pdb.min_available is not None:
            min_avail = _resolve_count(pdb.min_available, len(pods))
            return max(healthy - min_avail, 0)
        if pdb.max_unavailable is not None:
            max_unavail = _resolve_count(pdb.max_unavailable, len(pods))
            unhealthy = len(pods) - healthy
            return max(max_unavail - unhealthy, 0)
        return 1 << 30

    # -- convenience for the volume layer --------------------------------
    def get_pvc(self, namespace: str, name: str):
        return self.try_get("pvcs", name, namespace)

    def get_storage_class(self, name: str):
        return self.try_get("storageclasses", name) if name else None

    def get_pv(self, name: str):
        return self.try_get("pvs", name) if name else None


def _resolve_count(value, total: int) -> int:
    s = str(value)
    if s.endswith("%"):
        import math

        return int(math.ceil(total * float(s[:-1]) / 100.0))
    return int(s)
