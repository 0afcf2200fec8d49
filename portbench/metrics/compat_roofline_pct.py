"""``compat_roofline_pct``: Σ least time / Σ device time over the profiled
compat launches, the least time of each from ``roofline.compat_bound_ms``
at its own shapes against the published H100 SXM peaks."""


def read(ctx):
    p = ctx.profile
    if not p or not p["compat"]:
        return None
    least = sum(c[0] for c in p["compat"])
    device = sum(c[1] for c in p["compat"])
    return 100.0 * least / device if device > 0 else None
