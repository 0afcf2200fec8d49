"""The client seam: the store surface controllers are allowed to touch.

The reference's controllers speak client-go's `client.Client` interface, not
etcd (operator.go:141; pkg/test/cachesyncingclient.go wraps the same seam
for tests). This module is our equivalent contract: `KubeClient` names every
operation a controller may perform, `KubeStore` (kube/store.py) is the
in-memory implementation, and anything that one day fronts a real
kube-apiserver implements the same surface — controllers never depend on
store internals.

Optimistic concurrency: `update` raises `ConflictError` when the caller's
object carries a stale resourceVersion (apiserver 409 semantics). The
synchronous controller ring aliases stored instances — those writes always
carry the current version — but any caller working from a snapshot copy
(a future concurrent worker, a remote client) conflicts and must re-read;
`retry_on_conflict` packages the standard re-read-and-reapply loop
(client-go's retry.RetryOnConflict).

The port's copy of ``karpenter_tpu/kube/client.py`` (imports changed).
"""

from __future__ import annotations


class KubeClient:
    """Abstract store surface (client-go client.Client analog)."""

    # -- CRUD ------------------------------------------------------------
    def create(self, kind: str, obj):
        raise NotImplementedError

    def get(self, kind: str, name: str, namespace: str = "default"):
        raise NotImplementedError

    def try_get(self, kind: str, name: str, namespace: str = "default"):
        raise NotImplementedError

    def update(self, kind: str, obj):
        raise NotImplementedError

    def delete(self, kind: str, obj_or_name, namespace: str = "default"):
        raise NotImplementedError

    def list(self, kind: str, namespace: str | None = None, predicate=None) -> list:
        raise NotImplementedError

    # -- watch -----------------------------------------------------------
    def drain_events(self) -> list:
        raise NotImplementedError

    # -- pod subresources ------------------------------------------------
    def bind(self, pod, node_name: str):
        raise NotImplementedError

    def evict(self, pod):
        raise NotImplementedError

    # -- volume resolution (scheduling/volumes.py consumers) -------------
    def get_pvc(self, namespace: str, name: str):
        raise NotImplementedError

    def get_storage_class(self, name: str):
        raise NotImplementedError

    def get_pv(self, name: str):
        raise NotImplementedError


def retry_on_conflict(fn, attempts: int = 5):
    """Run `fn()` retrying on StaleVersionError — the caller's fn must
    re-read the object each attempt (client-go retry.RetryOnConflict).
    Other ConflictErrors (create of an existing key, double bind) are not
    retried: no re-read can cure them."""
    from karpenter_tpu_torch.kube.store import StaleVersionError

    last = None
    for _ in range(attempts):
        try:
            return fn()
        except StaleVersionError as e:
            last = e
    raise last
