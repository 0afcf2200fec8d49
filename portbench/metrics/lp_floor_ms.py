"""``lp_floor_ms``: the median per decision of the program's
``relax.floor`` span, the LP floor's upload, PDHG and read
(ops/relax.py ``lp_bin_floor``). Nothing when no decision opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "relax.floor")
