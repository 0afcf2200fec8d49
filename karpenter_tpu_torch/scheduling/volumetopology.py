"""Volume topology injection: PV/StorageClass zone pins become pod
node-affinity requirements.

Mirror of the reference's pkg/controllers/provisioning/scheduling/
volumetopology.go:42-152: a pod mounting a PVC bound to a zonal PV must
schedule into that zone; an unbound PVC whose StorageClass restricts
AllowedTopologies must land where the volume can be provisioned. The
derived requirements are appended to EVERY required node-selector term so
they AND with existing constraints and survive preference relaxation.

The port's copy of ``karpenter_tpu/scheduling/volumetopology.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.objects import (
    Affinity,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
)


class PVCError(Exception):
    """Pod references a PVC that can't be resolved (validatePVCs,
    volumetopology.go:155)."""


class VolumeTopology:
    def __init__(self, kube):
        self.kube = kube

    # -- derive (getRequirements, volumetopology.go:81) ------------------
    def requirements_for(self, pod) -> list:
        out = []
        for v in getattr(pod, "volumes", None) or []:
            claim = getattr(v, "claim_name", None) or (v if isinstance(v, str) else None)
            if claim is None:
                continue  # emptyDir/hostPath etc. carry no PVC
            pvc = self.kube.get_pvc(pod.namespace, claim)
            if pvc is None:
                continue  # validation (below) reports this separately
            if pvc.volume_name:
                out.extend(self._pv_requirements(pvc.volume_name))
            elif pvc.storage_class_name:
                out.extend(self._storage_class_requirements(pvc.storage_class_name))
        return out

    def _pv_requirements(self, volume_name: str) -> list:
        pv = self.kube.get_pv(volume_name)
        if pv is None or not pv.node_affinity_required:
            return []
        # terms are ORed; mirror the reference in using only the first
        reqs = list(pv.node_affinity_required[0].match_expressions)
        if pv.local:
            # a Local/HostPath PV's hostname pin is void on reschedule
            reqs = [r for r in reqs if r.key != wk.HOSTNAME_LABEL]
        return reqs

    def _storage_class_requirements(self, name: str) -> list:
        sc = self.kube.get_storage_class(name)
        if sc is None or not sc.allowed_topologies:
            return []
        first = sc.allowed_topologies[0]
        return [
            NodeSelectorRequirement(t["key"], "In", list(t["values"]))
            for t in first.get("match_label_expressions", [])
        ]

    # -- inject (volumetopology.go:42) -----------------------------------
    def inject(self, pod) -> None:
        reqs = self.requirements_for(pod)
        if not reqs:
            return
        if pod.affinity is None:
            pod.affinity = Affinity()
        if pod.affinity.node_affinity is None:
            pod.affinity.node_affinity = NodeAffinity()
        na = pod.affinity.node_affinity
        if not na.required:
            na.required = [NodeSelectorTerm()]
        # AND into every ORed term so relaxation can't drop the volume pin
        for term in na.required:
            term.match_expressions = list(term.match_expressions) + list(reqs)

    # -- validate (ValidatePersistentVolumeClaims) -----------------------
    def validate(self, pod) -> None:
        for v in getattr(pod, "volumes", None) or []:
            claim = getattr(v, "claim_name", None) or (v if isinstance(v, str) else None)
            if claim is None:
                continue
            pvc = self.kube.get_pvc(pod.namespace, claim)
            if pvc is None:
                raise PVCError(f"pvc {pod.namespace}/{claim} not found")
            if pvc.volume_name:
                if self.kube.get_pv(pvc.volume_name) is None:
                    raise PVCError(f"pv {pvc.volume_name} not found")
            elif pvc.storage_class_name:
                if self.kube.get_storage_class(pvc.storage_class_name) is None:
                    raise PVCError(
                        f"storageclass {pvc.storage_class_name} not found")
