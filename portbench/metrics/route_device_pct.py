"""``route_device_pct``: the share of the window's decisions whose engine
(``TorchSolver.last_device_stats["engine"]``) is the card."""


def read(ctx):
    engines = [d["engine"] for d in ctx.all_decisions]
    if not engines:
        return None
    return 100.0 * sum(e == "cuda" for e in engines) / len(engines)
