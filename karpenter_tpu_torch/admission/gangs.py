"""Gang (all-or-nothing pod-group) collection and co-location injection.

A gang is every pending pod sharing a ``karpenter.sh/pod-group``
annotation value (api/labels.py POD_GROUP_ANNOTATION). Two optional
annotations refine it:

* ``karpenter.sh/pod-group-min-member``: the group is only admissible once
  at least this many members are pending — fewer routes the whole group
  (reason ``oversize``) until the rest arrive, the PodGroup minMember
  semantics of the MPI/gang schedulers (arxiv 2603.22691).
* ``karpenter.sh/pod-group-topology``: a topology key (e.g. the zone
  label) all members must co-locate on — slice adjacency expressed through
  the EXISTING topology overlay: each member clone gets the solve-internal
  ``POD_GROUP_LABEL`` stamped and a required pod-affinity term on that key
  selecting the gang label, which the host Topology engine and the waves
  compiler already understand. Nothing new reaches the kernel.

Gang priority is the MAX of its members' effective priorities (a gang is
one schedulable unit; its most urgent member sets its tier), and the gang
solves atomically inside that tier (plane.py owns the trial/promote flow).

The port's copy of ``karpenter_tpu/admission/gangs.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.objects import (
    Affinity,
    LabelSelector,
    PodAffinity,
    PodAffinityTerm,
)

__all__ = ["Gang", "collect_gangs", "inject_colocation"]


class Gang:
    def __init__(self, name: str, pods: list, prio_of: dict):
        self.name = name
        self.pods = list(pods)
        self.priority = max(prio_of[p.uid] for p in pods)
        self.min_member = _min_member(pods)
        self.topology_key = _topology_key(pods)

    def __repr__(self):
        return (f"Gang({self.name}, pods={len(self.pods)}, "
                f"prio={self.priority}, min={self.min_member})")


def _min_member(pods) -> int:
    for p in pods:
        raw = p.metadata.annotations.get(wk.POD_GROUP_MIN_ANNOTATION)
        if raw is not None:
            try:
                return max(int(raw), 1)
            except (TypeError, ValueError):
                return 1
    return 1


def _topology_key(pods) -> str:
    for p in pods:
        key = p.metadata.annotations.get(wk.POD_GROUP_TOPOLOGY_ANNOTATION)
        if key:
            return key
    return ""


def collect_gangs(pods, prio_of: dict) -> tuple:
    """(gangs sorted by (-priority, name), loose pods in input order)."""
    by_name: dict = {}
    loose = []
    for p in pods:
        name = p.metadata.annotations.get(wk.POD_GROUP_ANNOTATION)
        if name:
            by_name.setdefault(name, []).append(p)
        else:
            loose.append(p)
    gangs = [Gang(name, members, prio_of) for name, members in by_name.items()]
    gangs.sort(key=lambda g: (-g.priority, g.name))
    return gangs, loose


def inject_colocation(gang: Gang, clones: list) -> list:
    """Stamp the gang label + the co-location affinity term onto the
    gang's CLONES (the originals never carry solve-internal fields). A
    gang without a topology key passes through untouched — atomicity alone
    needs no constraint."""
    if not gang.topology_key:
        return clones
    selector = LabelSelector(match_labels={wk.POD_GROUP_LABEL: gang.name})
    for c in clones:
        c.metadata.labels = {**c.metadata.labels,
                             wk.POD_GROUP_LABEL: gang.name}
        aff = c.affinity or Affinity()
        pa = aff.pod_affinity or PodAffinity()
        pa.required = list(pa.required) + [
            PodAffinityTerm(topology_key=gang.topology_key,
                            label_selector=selector)
        ]
        aff.pod_affinity = pa
        c.affinity = aff
    return clones
