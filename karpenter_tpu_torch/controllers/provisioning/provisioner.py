"""The provisioner's scheduler-input assembly.

The port's copy of part of ``karpenter_tpu/controllers/provisioning/
provisioner.py``: for now only ``collect_domains``, the topology domain
universe every provisioning round hands to ``Topology``. The rest of the
provisioner (batching, the cluster-state view, NodeClaim creation) is a
later slice of the port (ROADMAP.md Queue 1).
"""

from __future__ import annotations


def collect_domains(domains: dict, template, instance_types):
    """Topology domain universe: values from instance-type requirements
    compatible with the nodepool (provisioner.go:264-296). Shared by the
    provisioner and the perf harness (which must assemble the same scheduler
    inputs the product path does)."""
    np_reqs = template.requirements
    for key, req in np_reqs.items():
        if not req.complement:
            domains.setdefault(key, set()).update(req.values)
    for it in instance_types:
        if it.requirements.intersects(np_reqs) is not None:
            continue
        for key, req in it.requirements.items():
            if req.complement:
                continue
            allowed = np_reqs.get_req(key)
            vals = {v for v in req.values if allowed.has(v)}
            if vals:
                domains.setdefault(key, set()).update(vals)
