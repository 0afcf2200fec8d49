"""``global_ms``: the median per decision of the program's
``method.GlobalConsolidation`` span: the joint retirement plan (its LP
relax rung, the counterfactual row ladder, rounding and repair) and the
one confirming simulation (controllers/disruption/methods.py
``GlobalConsolidation``). Nothing when no decision opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "method.GlobalConsolidation")
