"""``decode_ms``: the median per decision of the program's ``solve.decode``
span, the decode (models/solver.py _decode). Nothing when no decision
opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "solve.decode")
