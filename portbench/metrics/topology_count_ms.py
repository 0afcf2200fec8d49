"""``topology_count_ms``: the median per decision of the program's
``topology.count`` spans, the counts of each topology group's domains
from the running cluster's pods (models/topology.py ``_count_domains``
and ``_update_inverse_affinities``), summed over the decision. Nothing
when no decision opened one."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "topology.count")
