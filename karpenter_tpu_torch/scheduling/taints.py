"""Taint/toleration checks (reference pkg/scheduling/taints.go)."""

from __future__ import annotations

from karpenter_tpu_torch.api.objects import Taint

# Taints expected to be transient during node startup (taints.go KnownEphemeralTaints)
KNOWN_EPHEMERAL_TAINTS = (
    Taint(key="node.kubernetes.io/not-ready", effect="NoSchedule"),
    Taint(key="node.kubernetes.io/unreachable", effect="NoSchedule"),
    Taint(key="node.cloudprovider.kubernetes.io/uninitialized", value="true", effect="NoSchedule"),
)


class Taints(list):
    """Decorated list of Taint (taints.go:38)."""

    def tolerates(self, pod) -> str | None:
        """None if the pod tolerates every taint, else an error string
        (taints.go Tolerates:41)."""
        errs = []
        for taint in self:
            if not any(t.tolerates(taint) for t in pod.tolerations):
                errs.append(f"did not tolerate {taint.key}={taint.value}:{taint.effect}")
        return "; ".join(errs) if errs else None

    def merge(self, other) -> "Taints":
        """Union keeping self's entries on (key, effect) conflicts
        (taints.go Merge:56)."""
        out = Taints(self)
        for taint in other:
            if not any(taint.matches(t) for t in out):
                out.append(taint)
        return out
