"""``plan_ms``: the median per decision of the program's ``solve.plan``
span, the bin-axis estimate with its LP floor (models/solver.py
``TorchSolver.plan``). Nothing when no decision opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "solve.plan")
