"""``topology_ms``: the median per decision of the program's
``topology.build`` span, the host topology engine's construction
(models/topology.py ``Topology``). Nothing when no decision opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "topology.build")
