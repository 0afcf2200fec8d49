"""``existing_capacity_ms``: the median per decision of the program's
``existing.capacity`` span, the existing nodes' availability, requirement
rows and group-node compatibility (ops/tensorize.py
``tensorize_existing``). Nothing when no decision opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "existing.capacity")
