"""The headline provisioning burst, built from the port's own objects.

The copy of ``bench.py``'s ``build_workload``: ``n_pods`` pending pods in
24 deployment shapes (six cpu/memory sizes × four selectors: none,
amd64, arm64, spot), two NodePools (``general``, and ``spot`` at weight
10) and ``benchmark_catalog(n_types)``. The headline is 50,000 pods × 500
types.
"""

from __future__ import annotations

GIB = 2**30


def build_workload(n_pods=50_000, n_types=500):
    """(pods, templates, instance_types_by_pool) for one burst."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.nodepool import NodePool
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_tpu_torch.cloudprovider.catalog import benchmark_catalog
    from karpenter_tpu_torch.models.inflight import ClaimTemplate

    catalog = benchmark_catalog(n_types)
    pools = [NodePool(metadata=ObjectMeta(name="general"))]
    spot = NodePool(metadata=ObjectMeta(name="spot"))
    spot.spec.weight = 10
    pools.append(spot)

    shapes = []
    sizes = [(0.1, 0.25), (0.25, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 8.0), (4.0, 16.0)]
    selectors = [
        {},
        {wk.ARCH_LABEL: "amd64"},
        {wk.ARCH_LABEL: "arm64"},
        {wk.CAPACITY_TYPE_LABEL: "spot"},
    ]
    for cpu, mem in sizes:
        for sel in selectors:
            shapes.append(({"cpu": cpu, "memory": mem * GIB}, sel))

    pods = []
    for i in range(n_pods):
        req, sel = shapes[i % len(shapes)]
        # spec sub-objects shared by reference, like clone-stamped replicas
        pods.append(
            Pod(metadata=ObjectMeta(name=f"p{i}"), requests=req, node_selector=sel)
        )
    templates = [ClaimTemplate(p) for p in pools]
    its = {p.name: catalog for p in pools}
    return pods, templates, its
