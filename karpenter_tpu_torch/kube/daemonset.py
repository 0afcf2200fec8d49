"""DaemonSet controller stand-in for the hermetic cluster.

The reference's envtest has no controller-manager, so daemon pods never
materialize there either — but our end-to-end loop models node capacity
consumption, and daemonset overhead is only real if daemon pods actually
occupy nodes. This stamps one pod per (daemonset, eligible node), bound
directly, the way the real daemonset controller + default scheduler would.
Eligibility mirrors the provisioner's overhead filter: tolerates the node's
taints and the node's labels satisfy the template's requirements.

The port's copy of ``karpenter_tpu/kube/daemonset.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.scheduling import daemon_schedulable, label_requirements


class DaemonSetController:
    def __init__(self, store):
        self.store = store

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        from karpenter_tpu_torch.utils import resources as resutil

        progressed = False
        nodes = [
            n
            for n in self.store.list("nodes")
            if n.ready and n.metadata.deletion_timestamp is None
        ]
        # remaining capacity per node: daemon pods only land where they fit
        used: dict = {n.name: {} for n in nodes}
        for p in self.store.list("pods"):
            if p.node_name in used and p.metadata.deletion_timestamp is None:
                used[p.node_name] = resutil.merge(used[p.node_name], p.effective_requests())
        for ds in self.store.list("daemonsets"):
            if ds.template is None:
                continue
            for node in nodes:
                name = f"{ds.metadata.name}-{node.name}"
                if self.store.try_get("pods", name, ds.metadata.namespace) is not None:
                    continue
                tmpl = ds.template
                if not daemon_schedulable(tmpl, node.taints, label_requirements(node.labels)):
                    continue
                free = resutil.subtract(node.allocatable, used[node.name])
                if not resutil.fits(tmpl.effective_requests(), free):
                    continue  # would overcommit: the real scheduler leaves it Pending
                p = tmpl.clone()
                p.metadata.name = name
                p.metadata.namespace = ds.metadata.namespace
                from karpenter_tpu_torch.api.objects import new_uid

                p.metadata.uid = new_uid("dspod")
                p.metadata.owner_references = [
                    {"kind": "DaemonSet", "name": ds.metadata.name, "controller": True}
                ]
                self.store.create("pods", p)
                self.store.bind(p, node.name)
                used[node.name] = resutil.merge(used[node.name], p.effective_requests())
                progressed = True
        return progressed
