"""Well-known labels, annotations, taints, and restriction rules.

Semantics from the reference's pkg/apis/v1beta1/labels.go:30-115 and
pkg/apis/v1beta1/taints.go. These strings are the shared vocabulary between
NodePools, pods, and instance-type catalogs; the tensorizer (ops/tensorize.py)
interns them into integer ids.
"""

from __future__ import annotations

GROUP = "karpenter.sh"

# k8s core labels
HOSTNAME_LABEL = "kubernetes.io/hostname"
TOPOLOGY_ZONE_LABEL = "topology.kubernetes.io/zone"
TOPOLOGY_REGION_LABEL = "topology.kubernetes.io/region"
INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"
ARCH_LABEL = "kubernetes.io/arch"
OS_LABEL = "kubernetes.io/os"
WINDOWS_BUILD_LABEL = "node.kubernetes.io/windows-build"

# architectures / capacity types
ARCHITECTURE_AMD64 = "amd64"
ARCHITECTURE_ARM64 = "arm64"
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"

# karpenter labels
NODEPOOL_LABEL = f"{GROUP}/nodepool"
NODE_INITIALIZED_LABEL = f"{GROUP}/initialized"
NODE_REGISTERED_LABEL = f"{GROUP}/registered"
CAPACITY_TYPE_LABEL = f"{GROUP}/capacity-type"

# karpenter annotations
DO_NOT_DISRUPT_ANNOTATION = f"{GROUP}/do-not-disrupt"
NODEPOOL_HASH_ANNOTATION = f"{GROUP}/nodepool-hash"
NODEPOOL_HASH_VERSION_ANNOTATION = f"{GROUP}/nodepool-hash-version"
NODEPOOL_HASH_VERSION = "v2"  # current static-hash protocol version
MANAGED_BY_ANNOTATION = f"{GROUP}/managed-by"

# gang (all-or-nothing pod-group) admission — karpenter_tpu/admission/gangs.py
POD_GROUP_ANNOTATION = f"{GROUP}/pod-group"
POD_GROUP_MIN_ANNOTATION = f"{GROUP}/pod-group-min-member"
POD_GROUP_TOPOLOGY_ANNOTATION = f"{GROUP}/pod-group-topology"
# solve-internal label stamped on gang CLONES so the injected co-location
# pod-affinity term has a selector to match (never written to the store)
POD_GROUP_LABEL = f"{GROUP}/pod-group"

# finalizers
TERMINATION_FINALIZER = f"{GROUP}/termination"

# taints (pkg/apis/v1beta1/taints.go)
DISRUPTION_TAINT_KEY = f"{GROUP}/disruption"
DISRUPTION_TAINT_VALUE = "disrupting"
UNREGISTERED_TAINT_KEY = f"{GROUP}/unregistered"

RESTRICTED_LABEL_DOMAINS = frozenset({"kubernetes.io", "k8s.io", GROUP})

LABEL_DOMAIN_EXCEPTIONS = frozenset(
    {"kops.k8s.io", "node.kubernetes.io", "node-restriction.kubernetes.io"}
)

WELL_KNOWN_LABELS = frozenset(
    {
        NODEPOOL_LABEL,
        TOPOLOGY_ZONE_LABEL,
        TOPOLOGY_REGION_LABEL,
        INSTANCE_TYPE_LABEL,
        ARCH_LABEL,
        OS_LABEL,
        CAPACITY_TYPE_LABEL,
        WINDOWS_BUILD_LABEL,
    }
)

# labels that interfere with provisioning logic (labels.go RestrictedLabels)
RESTRICTED_LABELS = frozenset({HOSTNAME_LABEL})

# aliased concepts normalized to the canonical label (labels.go NormalizedLabels)
NORMALIZED_LABELS = {
    "failure-domain.beta.kubernetes.io/zone": TOPOLOGY_ZONE_LABEL,
    "failure-domain.beta.kubernetes.io/region": TOPOLOGY_REGION_LABEL,
    "beta.kubernetes.io/arch": ARCH_LABEL,
    "beta.kubernetes.io/os": OS_LABEL,
    "beta.kubernetes.io/instance-type": INSTANCE_TYPE_LABEL,
}


def normalize(key: str) -> str:
    return NORMALIZED_LABELS.get(key, key)


def _domain(key: str) -> str:
    return key.split("/", 1)[0] if "/" in key else ""


def is_restricted_node_label(key: str) -> bool:
    """True if karpenter must not inject this label onto nodes
    (labels.go IsRestrictedNodeLabel)."""
    if key in WELL_KNOWN_LABELS:
        return False
    dom = _domain(key)
    in_restricted = any(dom == d or dom.endswith("." + d) for d in RESTRICTED_LABEL_DOMAINS)
    in_exception = any(dom == d or dom.endswith("." + d) for d in LABEL_DOMAIN_EXCEPTIONS)
    return (in_restricted and not in_exception) or key in RESTRICTED_LABELS


def is_restricted_label(key: str) -> str | None:
    """Returns an error string if the label may not be used in specs
    (labels.go IsRestrictedLabel)."""
    if key in WELL_KNOWN_LABELS:
        return None
    if is_restricted_node_label(key):
        return (
            f"label {key} is restricted; specify a well known label "
            f"or a custom label that does not use a restricted domain"
        )
    return None
