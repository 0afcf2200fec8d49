"""Node / NodePool / Pod state exporters.

Each poll() rebuilds its gauge families from the store — the
delete-then-set sweep the reference's metrics controllers use
(pkg/controllers/metrics/node/controller.go etc.).

The port's copy of ``karpenter_tpu/controllers/metrics/exporters.py`` (imports changed).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.controllers.nodepool.counter import aggregate_pool_usage
from karpenter_tpu_torch.operator import metrics as m
from karpenter_tpu_torch.utils import resources as resutil


class NodeMetricsController:
    def __init__(self, store, registry=None):
        self.store = store
        self.registry = registry or m.REGISTRY

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        alloc = self.registry.gauge(m.NODES_ALLOCATABLE, "node allocatable by resource")
        total = self.registry.gauge(m.NODES_TOTAL, "nodes by nodepool")
        alloc.clear()
        total.clear()
        counts: dict = {}
        for node in self.store.list("nodes"):
            pool = node.labels.get(wk.NODEPOOL_LABEL, "")
            counts[pool] = counts.get(pool, 0) + 1
            for r, v in node.allocatable.items():
                alloc.inc(v, node_name=node.name, nodepool=pool, resource_type=r)
        for pool, n in counts.items():
            total.set(n, nodepool=pool)
        return False  # metrics sweeps never change cluster state


class PodMetricsController:
    def __init__(self, store, registry=None):
        self.store = store
        self.registry = registry or m.REGISTRY

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        g = self.registry.gauge(m.PODS_STATE, "pods by phase/binding")
        g.clear()
        for pod in self.store.list("pods"):
            g.inc(1, phase=pod.phase, bound=str(bool(pod.node_name)).lower(),
                  namespace=pod.namespace)
        return False


class NodePoolMetricsController:
    def __init__(self, store, registry=None):
        self.store = store
        self.registry = registry or m.REGISTRY

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        usage = self.registry.gauge(m.NODEPOOL_USAGE, "owned capacity by resource")
        limit = self.registry.gauge(m.NODEPOOL_LIMIT, "spec.limits by resource")
        usage.clear()
        limit.clear()
        for np in self.store.list("nodepools"):
            for r, v in aggregate_pool_usage(self.store, np).items():
                usage.set(v, nodepool=np.name, resource_type=r)
            for r, v in resutil.parse_resources(np.spec.limits or {}).items():
                limit.set(v, nodepool=np.name, resource_type=r)
        return False
