"""Progressive soft-constraint relaxation.

Behavioral mirror of the reference's Preferences.Relax
(pkg/controllers/provisioning/scheduling/preferences.go:38-147): each call
applies exactly ONE relaxation, trying in order — drop a required
node-affinity OR-alternative, drop the heaviest preferred pod-affinity /
pod-anti-affinity / node-affinity term, drop a ScheduleAnyway topology
spread, and (when enabled) tolerate PreferNoSchedule taints.
"""

from __future__ import annotations

from karpenter_tpu_torch.api.objects import Toleration, sort_terms_by_weight


class Preferences:
    def __init__(self, tolerate_prefer_no_schedule: bool = False):
        self.tolerate_prefer_no_schedule = tolerate_prefer_no_schedule

    def relax(self, pod) -> bool:
        relaxations = [
            self._remove_required_node_affinity_term,
            self._remove_preferred_pod_affinity_term,
            self._remove_preferred_pod_anti_affinity_term,
            self._remove_preferred_node_affinity_term,
            self._remove_topology_spread_schedule_anyway,
        ]
        if self.tolerate_prefer_no_schedule:
            relaxations.append(self._tolerate_prefer_no_schedule_taints)
        for fn in relaxations:
            if fn(pod):
                return True
        return False

    @staticmethod
    def _remove_required_node_affinity_term(pod) -> bool:
        na = pod.affinity.node_affinity if pod.affinity else None
        # OR-alternatives: drop the first term so the next is tried; the last
        # term can never be removed
        if na and len(na.required) > 1:
            na.required = na.required[1:]
            return True
        return False

    @staticmethod
    def _remove_preferred_pod_affinity_term(pod) -> bool:
        pa = pod.affinity.pod_affinity if pod.affinity else None
        if pa and pa.preferred:
            pa.preferred = sort_terms_by_weight(pa.preferred)[1:]
            return True
        return False

    @staticmethod
    def _remove_preferred_pod_anti_affinity_term(pod) -> bool:
        pa = pod.affinity.pod_anti_affinity if pod.affinity else None
        if pa and pa.preferred:
            pa.preferred = sort_terms_by_weight(pa.preferred)[1:]
            return True
        return False

    @staticmethod
    def _remove_preferred_node_affinity_term(pod) -> bool:
        na = pod.affinity.node_affinity if pod.affinity else None
        if na and na.preferred:
            na.preferred = sort_terms_by_weight(na.preferred)[1:]
            return True
        return False

    @staticmethod
    def _remove_topology_spread_schedule_anyway(pod) -> bool:
        for i, tsc in enumerate(pod.topology_spread_constraints):
            if tsc.when_unsatisfiable == "ScheduleAnyway":
                pod.topology_spread_constraints = (
                    pod.topology_spread_constraints[:i] + pod.topology_spread_constraints[i + 1 :]
                )
                return True
        return False

    @staticmethod
    def _tolerate_prefer_no_schedule_taints(pod) -> bool:
        tol = Toleration(operator="Exists", effect="PreferNoSchedule")
        if any(
            t.key == tol.key and t.operator == tol.operator and t.effect == tol.effect
            for t in pod.tolerations
        ):
            return False
        pod.tolerations = list(pod.tolerations) + [tol]
        return True
