"""CSI volume-count tracking vs per-driver node limits.

Semantics from the reference's pkg/scheduling/volumeusage.go:45-220: resolve
each pod PVC to its storage-class provisioner (driver), count distinct
volumes per driver per node, and reject adds that would exceed the driver's
volume-attach limit on that node.
"""

from __future__ import annotations


class VolumeUsage:
    def __init__(self):
        self._by_driver: dict = {}  # driver -> set of volume ids
        self._by_pod: dict = {}  # pod key -> [(driver, volume_id)]

    @staticmethod
    def pod_volumes(pod, kube=None) -> list:
        """Resolve pod PVC refs → (driver, volume_id) via the cluster's
        PVC/StorageClass objects when a kube view is provided."""
        out = []
        for v in getattr(pod, "volumes", None) or []:
            claim = getattr(v, "claim_name", None) or (v if isinstance(v, str) else None)
            if claim is None:
                continue
            driver, vol_id = "", f"{pod.namespace}/{claim}"
            if kube is not None:
                pvc = kube.get_pvc(pod.namespace, claim)
                if pvc is not None:
                    sc = kube.get_storage_class(getattr(pvc, "storage_class_name", ""))
                    driver = getattr(sc, "provisioner", "") if sc is not None else ""
                    vol_id = getattr(pvc, "volume_name", "") or vol_id
            out.append((driver, vol_id))
        return out

    def exceeds(self, pod, limits: dict, kube=None) -> str | None:
        """Error if adding the pod would exceed any driver limit on the node
        (limits: driver -> max volumes; missing driver = unlimited)."""
        if not limits:
            return None
        additions: dict = {}
        for driver, vol in self.pod_volumes(pod, kube):
            if vol not in self._by_driver.get(driver, ()):  # new distinct volume
                additions[driver] = additions.get(driver, 0) + 1
        for driver, extra in additions.items():
            if driver in limits:
                used = len(self._by_driver.get(driver, ()))
                if used + extra > limits[driver]:
                    return f"would exceed volume limit for driver {driver} ({used}+{extra}>{limits[driver]})"
        return None

    def add(self, pod, kube=None):
        vols = self.pod_volumes(pod, kube)
        if not vols:
            # volume-less pods count nothing: an empty entry only bloats
            # every snapshot/fork copy to O(pods-on-node)
            self._by_pod.pop(pod.key(), None)
            return
        self._by_pod[pod.key()] = vols
        for driver, vol in vols:
            self._by_driver.setdefault(driver, set()).add(vol)

    def remove(self, pod_key: str):
        # Rebuild per-driver sets from the remaining pods: a PVC shared by
        # several pods must stay counted while any referent remains
        # (volumeusage.go DeletePod recomputes for exactly this case).
        if self._by_pod.pop(pod_key, None) is None:
            return
        rebuilt: dict = {}
        for vols in self._by_pod.values():
            for driver, vol in vols:
                rebuilt.setdefault(driver, set()).add(vol)
        self._by_driver = rebuilt

    def copy(self) -> "VolumeUsage":
        out = VolumeUsage()
        out._by_driver = {k: set(v) for k, v in self._by_driver.items()}
        out._by_pod = {k: list(v) for k, v in self._by_pod.items()}
        return out
