from karpenter_tpu_torch.scheduling.requirements import (  # noqa: F401
    IN,
    NOT_IN,
    EXISTS,
    DOES_NOT_EXIST,
    GT,
    LT,
    Requirement,
    Requirements,
    pod_requirements,
    strict_pod_requirements,
    label_requirements,
    node_selector_requirements,
    has_preferred_node_affinity,
)
from karpenter_tpu_torch.scheduling.taints import Taints, KNOWN_EPHEMERAL_TAINTS  # noqa: F401
from karpenter_tpu_torch.scheduling.hostports import HostPortUsage  # noqa: F401
from karpenter_tpu_torch.scheduling.volumes import VolumeUsage  # noqa: F401


def daemon_schedulable(template_pod, taints, requirements, allow_undefined=None) -> bool:
    """Would this daemonset pod template land on a node with the given
    taints and requirements? The single predicate behind daemon-overhead
    reservation (scheduler.go getDaemonOverhead) and the hermetic daemonset
    controller — they must agree or simulated reservations diverge from
    stamped pods."""
    if Taints(taints).tolerates(template_pod) is not None:
        return False
    return (
        requirements.compatible(
            pod_requirements(template_pod), allow_undefined=allow_undefined
        )
        is None
    )

__all__ = [
    "IN", "NOT_IN", "EXISTS", "DOES_NOT_EXIST", "GT", "LT",
    "Requirement", "Requirements", "pod_requirements",
    "strict_pod_requirements", "label_requirements",
    "node_selector_requirements", "has_preferred_node_affinity",
    "Taints", "KNOWN_EPHEMERAL_TAINTS", "HostPortUsage", "VolumeUsage",
    "daemon_schedulable",
]
