"""``waves_ms``: the median per decision of the program's ``waves.compile``
span, the topology compile (ops/waves.py). Nothing when no decision
opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "waves.compile")
