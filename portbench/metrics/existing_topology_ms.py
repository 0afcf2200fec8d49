"""``existing_topology_ms``: the median per decision of the program's
``existing.topology`` span, the existing nodes' conflict, spread and
affinity class counts from the waves plan (ops/tensorize.py
``tensorize_existing``). Nothing when no decision opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "existing.topology")
