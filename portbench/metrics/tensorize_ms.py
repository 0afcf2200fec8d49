"""``tensorize_ms``: the median per decision of the program's
``tensorize.build`` span, the tensorize layer (ops/tensorize.py).
Nothing when no decision opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "tensorize.build")
