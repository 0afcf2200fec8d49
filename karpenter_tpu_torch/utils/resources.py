"""Resource-list algebra.

Semantics follow the reference's pkg/utils/resources (resources.go:
RequestsForPods, Merge, Subtract, Fits:221, MaxResources:175, Cmp) but are
implemented on plain dict[str, float] resource lists, which also serve as the
row format for the device-side demand/allocatable tensors (ops/tensorize.py).
"""

from __future__ import annotations

from karpenter_tpu_torch.utils.quantity import parse_quantity

# Canonical resource names (subset of k8s core; extended resources are open-ended)
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"

ResourceList = dict  # dict[str, float]

_EPS = 1e-9
# relative slack for fit checks: byte-scale resources pass through float32
# device tensors whose ulp at 128Gi dwarfs any absolute epsilon. Shared by
# fits() and the solver's vectorized decode so the two paths cannot drift.
FIT_REL_EPS = 1e-6


def parse_resources(spec) -> ResourceList:
    """Parse {"cpu": "100m", "memory": "1Gi"} style specs into float lists."""
    if spec is None:
        return {}
    return {k: parse_quantity(v) for k, v in spec.items()}


def merge(*lists) -> ResourceList:
    """Element-wise sum across resource lists."""
    out: ResourceList = {}
    for rl in lists:
        if not rl:
            continue
        for k, v in rl.items():
            out[k] = out.get(k, 0.0) + v
    return out


def subtract(a: ResourceList, b: ResourceList) -> ResourceList:
    """a - b over the union of keys (may go negative, like the reference)."""
    out = dict(a or {})
    for k, v in (b or {}).items():
        out[k] = out.get(k, 0.0) - v
    return out


def max_resources(*lists) -> ResourceList:
    """Element-wise max — used for init-container request folding."""
    out: ResourceList = {}
    for rl in lists:
        for k, v in (rl or {}).items():
            if v > out.get(k, 0.0):
                out[k] = v
    return out


def fits(candidate: ResourceList, total: ResourceList) -> bool:
    """True iff every requested resource in candidate is available in total.

    A resource absent from total counts as zero capacity (so any positive
    request for it fails), matching resources.go:221. The tolerance is
    relative: byte-scale resources (memory) pass through float32 device
    tensors, whose ulp at 128Gi dwarfs any absolute epsilon.
    """
    for k, v in (candidate or {}).items():
        cap = total.get(k, 0.0)
        if v > cap + _EPS + FIT_REL_EPS * abs(cap):
            return False
    return True


def any_negative(rl: ResourceList) -> bool:
    return any(v < -_EPS for v in (rl or {}).values())


def exceeds(candidate: ResourceList, limits: ResourceList) -> list[str]:
    """Resource names in candidate exceeding limits; keys absent from limits
    are unconstrained (NodePool.Limits semantics, nodepool_status.go)."""
    out = []
    for k, lim in (limits or {}).items():
        if (candidate or {}).get(k, 0.0) > lim + _EPS:
            out.append(k)
    return out


def is_zero(rl: ResourceList) -> bool:
    return all(abs(v) <= _EPS for v in (rl or {}).values())


def pod_requests(pod) -> ResourceList:
    """Effective scheduling requests for a pod.

    Mirrors the kube-scheduler rule the reference relies on
    (pkg/utils/resources RequestsForPods): max(sum(containers),
    max(initContainers)) + pod overhead, plus an implicit "pods": 1.
    """
    container_sum = merge(*[c.get("requests", {}) for c in getattr(pod, "containers", None) or []])
    init_max = max_resources(*[c.get("requests", {}) for c in getattr(pod, "init_containers", None) or []])
    base = getattr(pod, "requests", None) or {}
    out = merge(max_resources(container_sum, init_max), base, getattr(pod, "overhead", None) or {})
    out[PODS] = 1.0
    return out
