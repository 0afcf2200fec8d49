"""``device_idle_pct``: the share of the profiled decisions' host-clock time
in which no operation ran on the card."""


def read(ctx):
    p = ctx.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
