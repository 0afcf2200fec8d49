"""Pod phase/ownership predicates (reference pkg/utils/pod/scheduling.go).

The port's copy of ``karpenter_tpu/utils/pod.py``.
"""

from __future__ import annotations


def is_scheduled(pod) -> bool:
    return bool(pod.node_name)


def is_terminal(pod) -> bool:
    return pod.phase in ("Succeeded", "Failed")


def is_terminating(pod) -> bool:
    return pod.metadata.deletion_timestamp is not None or pod.terminating


def is_owned_by_daemonset(pod) -> bool:
    return pod.owned_by_daemonset()


def is_owned_by_node(pod) -> bool:
    return any(o.get("kind") == "Node" for o in pod.metadata.owner_references)


def failed_to_schedule(pod) -> bool:
    return any(
        c.get("type") == "PodScheduled"
        and c.get("status") == "False"
        and c.get("reason") == "Unschedulable"
        for c in pod.conditions
    )


def is_provisionable(pod) -> bool:
    """scheduling.go IsProvisionable:82 — a pending pod karpenter should act
    on: marked unschedulable by the scheduler, not daemonset/static."""
    return (
        not is_scheduled(pod)
        and not is_terminal(pod)
        and not is_terminating(pod)
        and failed_to_schedule(pod)
        and not is_owned_by_daemonset(pod)
        and not is_owned_by_node(pod)
    )


def is_reschedulable(pod) -> bool:
    """scheduling.go IsReschedulable:42 — counts toward capacity we must
    recreate when disrupting its node. Daemonset pods are excluded: the
    daemonset controller recreates them on the replacement node, and their
    requests are already reserved as daemon overhead."""
    return (
        not is_terminal(pod)
        and not is_terminating(pod)
        and not is_owned_by_node(pod)
        and not is_owned_by_daemonset(pod)
    )


def is_evictable(pod) -> bool:
    """scheduling.go IsEvictable:55 — the drain path should evict it."""
    return not is_terminal(pod) and not is_terminating(pod)


def is_waiting_eviction(pod) -> bool:
    return not is_terminal(pod) and not is_terminating(pod)
