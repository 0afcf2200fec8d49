"""Workload controller stand-in: replicasets + pod garbage collection.

The reference relies on the real controller-manager to recreate evicted
pods (deployments → replicasets) and to delete pods orphaned by node
deletion (pod GC). The hermetic cluster needs both for disruption to be
observable end-to-end: a drain evicts pods, this controller recreates them
as fresh pending pods, and the provisioner/binder land them on surviving or
replacement capacity.

The port's copy of ``karpenter_tpu/kube/workload.py`` (imports changed).
"""

from __future__ import annotations

import itertools

_pod_seq = itertools.count(1)


class WorkloadController:
    def __init__(self, store):
        self.store = store

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        progressed = self._gc_orphans()
        # one pass over the pod list, indexed by owning deployment: the
        # naive per-deployment rescan is O(deployments × pods) and at fleet
        # scale (1000 deployments × 1000 pods) it dominated the whole
        # reconcile round — this is the controller-manager's informer-index
        # equivalent, not a behavior change (list order is preserved, so
        # scale-down still trims store-insertion order)
        owned_by: dict = {}
        for p in self.store.list("pods"):
            if p.metadata.deletion_timestamp is not None:
                continue
            for o in p.metadata.owner_references:
                if o.get("kind") == "Deployment":
                    owned_by.setdefault(
                        (p.metadata.namespace, o.get("name")), []
                    ).append(p)
        for deploy in self.store.list("deployments"):
            if deploy.template is None:
                continue
            owned = owned_by.get(
                (deploy.metadata.namespace, deploy.metadata.name), []
            )
            for extra in owned[deploy.replicas :]:
                # scale-down: newest-first would need creation ordering;
                # owned list order (store insertion) approximates it
                self.store.delete("pods", extra)
                progressed = True
            tmpl_sig = None
            for _ in range(deploy.replicas - len(owned)):
                p = deploy.template.clone()
                from karpenter_tpu_torch.api.objects import new_uid

                p.metadata.name = f"{deploy.metadata.name}-{next(_pod_seq)}"
                p.metadata.namespace = deploy.metadata.namespace
                p.metadata.uid = new_uid("pod")
                p.metadata.owner_references = [
                    {"kind": "Deployment", "name": deploy.metadata.name, "controller": True}
                ]
                p.node_name = ""
                p.phase = "Pending"
                p.conditions = []
                # stamp the scheduling signature at index build time: every
                # replica of one deployment is spec-identical to its
                # template (the fields edited above — name/uid/owner/
                # node_name/phase/conditions — are not signature inputs,
                # and clone() deep-copies are value-equal), so the burst's
                # first tensorize pays ONE signature hash per deployment
                # instead of one per pod. Computed fresh per poll (not
                # memoized on the template object) so an edited template
                # stamps its NEW signature; already-running pods keep the
                # old spec and the old signature, which stays correct for
                # them. Solver-side clones drop the cache (dataclasses.
                # replace copies declared fields only), preserving the
                # relaxation-mutates-clones invariant.
                if tmpl_sig is None:
                    from karpenter_tpu_torch.ops.tensorize import (
                        intern_signature,
                        pod_signature,
                    )

                    tmpl_sig = intern_signature(pod_signature(deploy.template))
                p.__dict__["_sig_cache"] = tmpl_sig
                self.store.create("pods", p)
                progressed = True
        return progressed

    def _gc_orphans(self) -> bool:
        """Delete pods bound to nodes that no longer exist (kube pod GC)."""
        progressed = False
        node_names = {n.name for n in self.store.list("nodes")}
        for p in list(self.store.list("pods")):
            if p.node_name and p.node_name not in node_names:
                if p.metadata.deletion_timestamp is None:
                    self.store.delete("pods", p)
                    progressed = True
        return progressed
