"""Core Kubernetes-shaped object model.

The reference consumes real k8s API types via client-go; our framework is
self-hosted, so this module defines the minimal-but-faithful pod/node model
that the constraint algebra (scheduling/), the tensorizer (ops/tensorize.py),
and the in-memory apiserver (kube/) all share. Field semantics follow
k8s core/v1 as used by the reference (e.g. Toleration.ToleratesTaint,
TopologySpreadConstraint fields consumed in
pkg/controllers/provisioning/scheduling/topologygroup.go).
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass, field, replace

from karpenter_tpu_torch.utils import resources as resutil

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "uid") -> str:
    return f"{prefix}-{next(_uid_counter)}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid())
    labels: dict = field(default_factory=dict)
    annotations: dict = field(default_factory=dict)
    finalizers: list = field(default_factory=list)
    owner_references: list = field(default_factory=list)  # [{kind, name, uid, controller}]
    creation_timestamp: float = 0.0
    deletion_timestamp: float | None = None
    resource_version: int = 0
    generation: int = 0


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute

    def matches(self, other: "Taint") -> bool:
        # v1.Taint.MatchTaint: key and effect equality
        return self.key == other.key and self.effect == other.effect


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: int | None = None

    def tolerates(self, taint: Taint) -> bool:
        """v1.Toleration.ToleratesTaint semantics."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass
class NodeSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: list = field(default_factory=list)
    min_values: int | None = None  # NodeSelectorRequirementWithMinValues (nodeclaim.go:60)


@dataclass
class NodeSelectorTerm:
    match_expressions: list = field(default_factory=list)  # [NodeSelectorRequirement]


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class LabelSelector:
    """metav1.LabelSelector: matchLabels AND matchExpressions."""

    match_labels: dict = field(default_factory=dict)
    match_expressions: list = field(default_factory=list)  # [NodeSelectorRequirement]

    def matches(self, labels: dict) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for expr in self.match_expressions:
            val = labels.get(expr.key)
            if expr.operator == "In":
                if val is None or val not in expr.values:
                    return False
            elif expr.operator == "NotIn":
                if val is not None and val in expr.values:
                    return False
            elif expr.operator == "Exists":
                if val is None:
                    return False
            elif expr.operator == "DoesNotExist":
                if val is not None:
                    return False
        return True


@dataclass
class PodAffinityTerm:
    topology_key: str
    label_selector: LabelSelector | None = None
    namespaces: list = field(default_factory=list)
    namespace_selector: LabelSelector | None = None


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    pod_affinity_term: PodAffinityTerm = None


@dataclass
class NodeAffinity:
    required: list = field(default_factory=list)  # [NodeSelectorTerm] (ORed)
    preferred: list = field(default_factory=list)  # [PreferredSchedulingTerm]


@dataclass
class PodAffinity:
    required: list = field(default_factory=list)  # [PodAffinityTerm]
    preferred: list = field(default_factory=list)  # [WeightedPodAffinityTerm]


@dataclass
class Affinity:
    node_affinity: NodeAffinity | None = None
    pod_affinity: PodAffinity | None = None
    pod_anti_affinity: PodAffinity | None = None


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    label_selector: LabelSelector | None = None
    min_domains: int | None = None
    node_affinity_policy: str = "Honor"  # Honor | Ignore
    node_taints_policy: str = "Ignore"  # Honor | Ignore


@dataclass
class PersistentVolumeClaimRef:
    claim_name: str
    read_only: bool = False


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class_name: str = ""
    volume_name: str = ""  # set once bound to a PV
    requests: dict = field(default_factory=dict)  # {"storage": bytes}
    phase: str = "Pending"  # Pending | Bound


@dataclass
class PersistentVolume:
    """Only the scheduling-relevant shape: required node affinity
    (zone pinning) and the local/hostPath marker that voids hostname
    affinity on reschedule (volumetopology.go:128-152)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    node_affinity_required: list = field(default_factory=list)  # [NodeSelectorTerm] (ORed)
    local: bool = False  # Local or HostPath volume source
    csi_driver: str = ""
    capacity: dict = field(default_factory=dict)


@dataclass
class VolumeAttachment:
    """storage.k8s.io VolumeAttachment: a CSI volume attached to a node.
    The termination controller awaits these draining away before releasing
    a node's finalizer (node/termination awaits volume detachment so
    stateful workloads never lose data to an early instance delete).
    Existence of the object is what blocks — the attach/detach controller
    deletes it once the volume is unmounted."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    attacher: str = ""  # CSI driver name
    node_name: str = ""
    pv_name: str = ""  # spec.source.persistentVolumeName


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    # [{key: str, values: [str]}] — first term's matchLabelExpressions
    # (storageclass AllowedTopologies, volumetopology.go:112-125)
    allowed_topologies: list = field(default_factory=list)
    volume_binding_mode: str = "WaitForFirstConsumer"


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    # scheduling inputs
    node_name: str = ""
    node_selector: dict = field(default_factory=dict)
    affinity: Affinity | None = None
    tolerations: list = field(default_factory=list)  # [Toleration]
    topology_spread_constraints: list = field(default_factory=list)
    requests: dict = field(default_factory=dict)  # direct resource requests
    containers: list = field(default_factory=list)  # [{"requests": {...}, "ports": [...]}]
    init_containers: list = field(default_factory=list)
    overhead: dict = field(default_factory=dict)
    host_ports: list = field(default_factory=list)  # [(ip, port, protocol)]
    volumes: list = field(default_factory=list)  # [PersistentVolumeClaimRef | str]
    priority: int | None = None
    priority_class_name: str = ""
    preemption_policy: str = ""
    scheduler_name: str = "default-scheduler"
    # status
    phase: str = "Pending"
    conditions: list = field(default_factory=list)  # [{"type","status","reason"}]
    nominated_node_name: str = ""
    terminating: bool = False

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def effective_requests(self) -> dict:
        return resutil.pod_requests(self)

    def owned_by_daemonset(self) -> bool:
        return any(o.get("kind") == "DaemonSet" for o in self.metadata.owner_references)

    def owner_key(self):
        for o in self.metadata.owner_references:
            if o.get("controller"):
                return (o.get("kind"), self.metadata.namespace, o.get("name"))
        return None

    def clone(self) -> "Pod":
        # affinity/spread/tolerations must be independent: the relaxation
        # ladder (models/preferences.py) mutates them in place
        return replace(
            self,
            metadata=replace(
                self.metadata,
                labels=dict(self.metadata.labels),
                annotations=dict(self.metadata.annotations),
            ),
            affinity=copy.deepcopy(self.affinity),
            tolerations=list(self.tolerations),
            topology_spread_constraints=copy.deepcopy(self.topology_spread_constraints),
        )


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provider_id: str = ""
    taints: list = field(default_factory=list)  # [Taint]
    startup_taints: list = field(default_factory=list)
    unschedulable: bool = False
    capacity: dict = field(default_factory=dict)
    allocatable: dict = field(default_factory=dict)
    ready: bool = True
    phase: str = "Running"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def labels(self) -> dict:
        return self.metadata.labels


@dataclass
class DaemonSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    template: "Pod" = None  # pod template stamped per node


@dataclass
class Deployment:
    """Replica workload: the hermetic runtime's replicaset analog — evicted
    pods are recreated so drains actually displace work."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    replicas: int = 1
    template: "Pod" = None


@dataclass
class Lease:
    """coordination.k8s.io Lease: kubelet heartbeats in kube-node-lease.
    Only the ownership shape matters here — leasegarbagecollection
    (leasegarbagecollection/controller.go:48) deletes leases whose owning
    Node is gone."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""


@dataclass
class NodeClass:
    """Provider-specific node configuration object (the KWOKNodeClass
    analog, kwok/apis/v1alpha1). NodePools reference one via
    spec.template.node_class_ref; nodepool.readiness
    (readiness/controller.go:52) mirrors its Ready condition."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    kind: str = "KWOKNodeClass"
    conditions: list = field(default_factory=list)  # [{"type","status"}]

    @property
    def name(self) -> str:
        return self.metadata.name

    def ready(self) -> bool:
        for c in self.conditions:
            ctype = c.type if hasattr(c, "type") else c.get("type")
            status = c.status if hasattr(c, "status") else c.get("status")
            if ctype == "Ready":
                return status == "True"
        return True  # no explicit condition = ready (kwok nodeclass is static)


@dataclass
class PriorityClass:
    """scheduling.k8s.io PriorityClass: the value a pod's
    ``priority_class_name`` resolves to (admission/priority.py owns the
    resolution matrix). ``global_default`` marks the class applied to pods
    that name no class; ``preemption_policy`` ("" = PreemptLowerPriority)
    rides onto pods resolved through the class."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    preemption_policy: str = ""  # "" (PreemptLowerPriority) | "Never"
    description: str = ""

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: LabelSelector = field(default_factory=LabelSelector)
    min_available: int | str | None = None
    max_unavailable: int | str | None = None
    disruptions_allowed: int = 0


def sort_terms_by_weight(terms: list) -> list:
    return sorted(terms, key=lambda t: -t.weight)
