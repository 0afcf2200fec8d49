"""``relax_ms``: the median per decision of the program's ``global.relax``
span, the joint LP relax rung of global consolidation (ops/relax.py
``joint_relax_plan``: the LP formulated over the candidates, its PDHG on
the card, the rounding window). Nothing when no decision opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "global.relax")
