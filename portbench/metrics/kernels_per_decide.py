"""``kernels_per_decide``: the CUDA kernel events of the profiled decisions
over their number."""


def read(ctx):
    p = ctx.profile
    if not p or not p["kernels"]:
        return None
    return p["kernels"] / p["decisions"]
