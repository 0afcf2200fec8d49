"""``topology_index_hit_pct``: the share of the topology groups' counts
that the index of the running pods answered without a walk of the
cluster, ``100 × (spans with walked = 0) / (spans with walked)`` over the
window's ``topology.count`` spans that carry a ``walked`` attribute (the
counts of models/topology.py ``_count_domains``; ``topology.STATS``
counts the same). Nothing where no span carries it, as in a program that
walks the cluster once per group."""

from portbench.metrics._spans import attrs


def read(ctx):
    hits = total = 0
    for decision in attrs(ctx, "topology.count"):
        for a in decision:
            if "walked" in a:
                total += 1
                hits += a["walked"] == 0
    if not total:
        return None
    return 100.0 * hits / total
