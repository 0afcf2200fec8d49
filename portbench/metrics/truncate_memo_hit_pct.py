"""``truncate_memo_hit_pct``: the share of the compatibility lookups of
the provisioner's truncation that its offering table's memo answered,
``100 × memo_hits / (memo_hits + compat_evals)`` summed over the window's
``provision.truncate`` spans (their attributes, counted in
cloudprovider/offering_table.py ``STATS``). Nothing where no span carries
the counts, as in a program without the table, or none looked up."""

from portbench.metrics._spans import attrs


def read(ctx):
    hits = evals = 0
    for decision in attrs(ctx, "provision.truncate"):
        for a in decision:
            if "memo_hits" in a and "compat_evals" in a:
                hits += a["memo_hits"]
                evals += a["compat_evals"]
    if not hits + evals:
        return None
    return 100.0 * hits / (hits + evals)
