"""``classify_ms``: the median per decision of the program's
``solve.classify`` span, the split of the batch into device-eligible and
host-routed pods (models/solver.py ``TorchSolver.solve``). Nothing when
no decision opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "solve.classify")
