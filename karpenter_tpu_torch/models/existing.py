"""ExistingNode: scheduling simulation against real (or in-flight) capacity.

The port's copy of ``karpenter_tpu/models/existing.py`` (imports changed).

Behavioral mirror of the reference's scheduling ExistingNode
(pkg/controllers/provisioning/scheduling/existingnode.go:40-120): wraps a
StateNode snapshot with the same admission pipeline as an in-flight claim —
taints → host ports → volume limits → requirement compatibility → topology
tightening → resource fit against the node's cached availability. Unlike a
claim, requirements come from the node's actual labels, so compatibility is
strict (no undefined-well-known-label allowance).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.scheduling import (
    IN,
    Requirement,
    Requirements,
    Taints,
    has_preferred_node_affinity,
    label_requirements,
    pod_requirements,
    strict_pod_requirements,
)
from karpenter_tpu_torch.utils import resources as resutil


class ExistingNode:
    def __init__(self, state_node, topology, daemon_resources: dict | None = None, kube=None):
        self.state_node = state_node
        self.topology = topology
        self.kube = kube
        self.pods: list = []  # newly scheduled this solve
        # daemonsets that have not yet landed on this node still reserve
        # their requests (existingnode.go:44-56, clamped at zero)
        remaining_daemons = resutil.subtract(
            daemon_resources or {}, state_node.daemonset_requests()
        )
        self.requests = {r: max(v, 0.0) for r, v in remaining_daemons.items()}
        self.cached_available = state_node.available()
        self.taints = Taints(state_node.taints())
        self.requirements = label_requirements(state_node.labels())
        self.requirements.add(Requirement(wk.HOSTNAME_LABEL, IN, [state_node.hostname]))
        topology.register(wk.HOSTNAME_LABEL, state_node.hostname)
        self.host_ports = state_node.host_port_usage
        self.volumes = state_node.volume_usage

    def fork(self, topology) -> "ExistingNode":
        """Cheap per-simulation copy of a prototype built at the same
        cluster-state generation: shares everything `add` never mutates in
        place (the taint set, the initial requirements — `add` REPLACES
        self.requirements with a fresh object rather than mutating — and
        the availability dicts) and copies what it does (usage trackers,
        the requests dict, the placed-pod list). Lets one disruption
        round's tensorized bundle serve every confirming simulation
        without re-running the O(E) ExistingNode constructor per solve."""
        out = object.__new__(ExistingNode)
        out.state_node = self.state_node
        out.topology = topology
        out.kube = self.kube
        out.pods = []
        out.requests = dict(self.requests)
        out.cached_available = self.cached_available
        out.taints = self.taints
        out.requirements = self.requirements
        out.host_ports = self.host_ports.copy()
        out.volumes = self.volumes.copy()
        topology.register(wk.HOSTNAME_LABEL, self.state_node.hostname)
        return out

    @property
    def name(self) -> str:
        return self.state_node.name

    @property
    def scheduled_pods(self) -> list:
        return self.pods

    def add(self, pod) -> str | None:
        """Try to place pod on this node; mutates only on success
        (existingnode.go Add:64)."""
        err = self.taints.tolerates(pod)
        if err:
            return err
        err = self.host_ports.conflicts(pod)
        if err:
            return f"checking host port usage, {err}"
        volume_limits = self._volume_limits()
        if volume_limits:
            err = self.volumes.exceeds(pod, volume_limits, kube=self.kube)
            if err:
                return f"checking volume usage, {err}"

        node_reqs = Requirements(*self.requirements.values())
        pod_reqs = pod_requirements(pod)
        strict = strict_pod_requirements(pod) if has_preferred_node_affinity(pod) else pod_reqs
        err = node_reqs.compatible(strict)
        if err:
            return f"incompatible requirements, {err}"
        node_reqs.add(*strict.values())

        topo_reqs, err = self.topology.add_requirements(strict, node_reqs, pod)
        if err:
            return err
        err = node_reqs.compatible(topo_reqs)
        if err:
            return err
        node_reqs.add(*topo_reqs.values())

        requests = resutil.merge(self.requests, pod.effective_requests())
        if not resutil.fits(requests, self.cached_available):
            return "exceeds node resources"

        self.pods.append(pod)
        self.requests = requests
        self.requirements = node_reqs
        self.topology.record(pod, node_reqs)
        self.host_ports.add(pod)
        if volume_limits:
            self.volumes.add(pod, kube=self.kube)
        return None

    def _volume_limits(self) -> dict:
        """Per-CSI-driver attachable volume limits advertised by the node
        (the reference resolves these from CSINode objects)."""
        node = self.state_node.node
        if node is None:
            return {}
        return getattr(node, "volume_limits", None) or {}

    def __repr__(self):
        return f"ExistingNode({self.name}, +pods={len(self.pods)})"
