"""State forking for gang trials and preemption confirms.

A gang must place atomically, and ``solver.solve`` commits placements onto
the existing nodes / topology / claims IN PLACE even when later pods fail
— so atomicity is achieved by solving against a FORK of the round's
mutable state and, on full success, PROMOTING the fork wholesale (the
trial IS the commit; there is no re-solve whose tie-breaks could diverge).
A failed trial is simply dropped.

What forks, and how:

* **Topology** — shallow copy with the group registries deep-copied
  (TopologyGroup holds only selectors/filters/count dicts); the cluster
  view stays shared by reference (read-only), memo/owner indexes reset.
* **ExistingNode** — ``ExistingNode.fork`` (the disruption-simulation
  primitive) rebound to the forked topology, with the pods placed by
  EARLIER tiers carried over (fork() clears them by design for
  counterfactuals; a cascade fork must preserve them so promotion loses
  nothing).
* **InFlightNodeClaim** — field-wise copy sharing the immutable template
  and taints; ``add`` replaces requirements/requests/instance_types rather
  than mutating, so sharing the current objects is safe.

The port's copy of ``karpenter_tpu/admission/fork.py`` (imports changed).
"""

from __future__ import annotations

import copy

from karpenter_tpu_torch.models.inflight import InFlightNodeClaim

__all__ = ["fork_topology", "fork_enode", "fork_claim", "fork_limits"]


def fork_topology(topology):
    if topology is None or not hasattr(topology, "topologies"):
        # a constraint-free round (None, or an already-stateless
        # NullTopology): nothing to fork — hand back a stateless hook so
        # ExistingNode.fork's register() call always has a receiver
        from karpenter_tpu_torch.models.scheduler import NullTopology

        return topology if topology is not None else NullTopology()
    out = copy.copy(topology)
    out.topologies = copy.deepcopy(topology.topologies)
    out.inverse_topologies = copy.deepcopy(topology.inverse_topologies)
    out.domains = {k: set(v) for k, v in topology.domains.items()}
    out.excluded_pods = set(topology.excluded_pods)
    out._sel_memo = {}
    # owner groups re-resolve lazily: update() on a fork only ever ADDS —
    # never un-registers a live group — which is exactly a trial's contract
    out._owner_tgs = {}
    return out


def fork_enode(en, topology):
    out = en.fork(topology)
    # fork() starts pods empty (per-simulation counterfactual); the
    # cascade's fork must carry the placements earlier tiers committed so
    # a promoted trial still reports them (requests already carried)
    out.pods = list(en.pods)
    return out


def fork_claim(claim, topology):
    out = object.__new__(InFlightNodeClaim)
    out.template = claim.template
    out.topology = topology
    out.daemon_resources = dict(claim.daemon_resources)
    out.instance_types = list(claim.instance_types)
    out.pods = list(claim.pods)
    out.requests = dict(claim.requests)
    out.requirements = claim.requirements.copy()
    out.hostname = claim.hostname
    out.taints = claim.taints
    out.host_ports = claim.host_ports.copy()
    return out


def fork_limits(limits):
    if not limits:
        return limits
    return {pool: dict(rem) for pool, rem in limits.items()}
