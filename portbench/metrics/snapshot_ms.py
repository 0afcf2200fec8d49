"""``snapshot_ms``: the median per decision of the program's
``snapshot.build`` span, the disruption snapshot's build over the fleet
(ops/consolidate.py ``build_disruption_snapshot``; the round's prewarm,
``disrupt.bundle``, opens it on a cold controller). Nothing when no
decision opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "snapshot.build")
