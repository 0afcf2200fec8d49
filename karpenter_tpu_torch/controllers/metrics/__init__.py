"""Metric exporter controllers: cluster state as Prometheus gauges.

Mirror of the reference's pkg/controllers/metrics/{node,nodepool,pod}
(controller.go in each): periodic sweeps rebuilding gauge families for
node allocatable, pod phase/state counts, and nodepool usage vs limit.

The port's copy of ``karpenter_tpu/controllers/metrics/__init__.py`` (imports changed).
"""

from karpenter_tpu_torch.controllers.metrics.exporters import (
    NodeMetricsController,
    NodePoolMetricsController,
    PodMetricsController,
)

__all__ = [
    "NodeMetricsController",
    "NodePoolMetricsController",
    "PodMetricsController",
]
