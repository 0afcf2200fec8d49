"""``unspanned_ms``: the median per decision of its wall time outside every
span the program opened (the decision's host-clock time less the spans
directly under the round the harness opens). Nothing with the tracer
off."""

import statistics


def read(ctx):
    values = [d["ms"] - d["top_ms"] for d in ctx.decisions if d.get("spans") is not None]
    return statistics.median(values) if values else None
