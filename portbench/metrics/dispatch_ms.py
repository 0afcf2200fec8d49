"""``dispatch_ms``: the median per decision of the program's
``solve.dispatch`` span, the host queuing the pack loop
(models/solver.py _invoke). Nothing when no decision opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "solve.dispatch")
