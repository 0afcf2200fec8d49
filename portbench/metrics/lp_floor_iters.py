"""``lp_floor_iters``: the LP floor's PDHG iterations per call over the
process, ``RELAX_STATS["floor_iters"] / RELAX_STATS["floor_calls"]``
(ops/relax.py); the ring repeats, so this is the window's mean. Nothing
where the program keeps no such count or the floor never ran."""


def read(ctx):
    from karpenter_tpu_torch.ops.relax import RELAX_STATS

    calls, iters = RELAX_STATS.get("floor_calls"), RELAX_STATS.get("floor_iters")
    if not calls or iters is None:
        return None
    return iters / calls
