"""Effective pod priority: the resolution matrix.

Mirror of the kube-apiserver's priority admission (priority plugin +
scheduling.k8s.io semantics), compressed to the fields our Pod model
carries (api/objects.py:231-233):

1. an explicit ``pod.priority`` wins outright (the apiserver stamps it);
2. else ``pod.priority_class_name`` resolves through the PriorityClass
   objects; a missing class falls back like an unset name;
3. else the cluster's global-default class (highest value wins a
   multi-default tie, then lexicographically-first name — deterministic
   where the apiserver's "newest" is not);
4. else priority 0.

Values resolved through a class are re-checked against the system-reserved
ranges (store admission rejects illegal CLASSES, but classes handed in as
plain dicts — tests, the perf harness — never passed admission): a
non-``system-`` class claiming the positive reserved band, or ANY class in
the negative reserved band, resolves to 0 with reason ``reserved-range``
instead of smuggling a system priority into the cascade.

The port's copy of ``karpenter_tpu/admission/priority.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.api.admission import (
    HIGHEST_USER_DEFINABLE_PRIORITY,
    SYSTEM_CLASS_PREFIX,
)

__all__ = [
    "resolve_priority",
    "default_class",
    "effective_priorities",
    "partition_tiers",
    "preemption_policy_of",
]


def default_class(classes: dict):
    """The global-default PriorityClass, or None. Ties (multiple defaults)
    break on (highest value, then name) so resolution is deterministic."""
    best = None
    for name in sorted(classes):
        pc = classes[name]
        if not getattr(pc, "global_default", False):
            continue
        if best is None or pc.value > best.value:
            best = pc
    return best


def _legal(value: int, class_name: str) -> bool:
    if value < -HIGHEST_USER_DEFINABLE_PRIORITY:
        return False  # negative system-reserved range: nobody's
    if value > HIGHEST_USER_DEFINABLE_PRIORITY:
        return class_name.startswith(SYSTEM_CLASS_PREFIX)
    return True


def resolve_priority(pod, classes: dict | None = None,
                     default=None) -> tuple:
    """(effective priority, reason) for one pod. ``classes`` maps class
    name -> PriorityClass; ``default`` is the pre-resolved global-default
    class (pass ``default_class(classes)`` — threaded separately so bulk
    callers resolve it once)."""
    classes = classes or {}
    if pod.priority is not None:
        return int(pod.priority), "spec"
    name = pod.priority_class_name or ""
    if name:
        pc = classes.get(name)
        if pc is not None:
            if not _legal(pc.value, name):
                return 0, "reserved-range"
            return int(pc.value), "class"
        # a named-but-missing class: the apiserver would have rejected the
        # pod at create; mid-flight deletions degrade to the default path
        if default is not None and _legal(default.value, default.name):
            return int(default.value), "missing-class-default"
        return 0, "missing-class"
    if default is not None:
        if not _legal(default.value, default.name):
            return 0, "reserved-range"
        return int(default.value), "default-class"
    return 0, "unset"


def preemption_policy_of(pod, classes: dict | None = None) -> str:
    """The pod's effective preemption policy: the spec field when set,
    else the policy of the class its priority resolved through, else ""
    (PreemptLowerPriority)."""
    if pod.preemption_policy:
        return pod.preemption_policy
    classes = classes or {}
    pc = classes.get(pod.priority_class_name or "")
    if pc is not None and getattr(pc, "preemption_policy", ""):
        return pc.preemption_policy
    return ""


def effective_priorities(pods, classes: dict | None = None) -> dict:
    """uid -> effective priority for a batch (one default-class resolve)."""
    classes = classes or {}
    dflt = default_class(classes)
    return {p.uid: resolve_priority(p, classes, dflt)[0] for p in pods}


def partition_tiers(pods, prio_of: dict) -> list:
    """[(priority, [pods])] in DESCENDING priority order; pod order within
    a tier preserves the input order (the FFD sort happens downstream)."""
    by_prio: dict = {}
    for p in pods:
        by_prio.setdefault(prio_of[p.uid], []).append(p)
    return [(prio, by_prio[prio]) for prio in sorted(by_prio, reverse=True)]
