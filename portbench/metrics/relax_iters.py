"""``relax_iters``: the joint LP relax rung's PDHG iterations per attempt
over the process, ``RELAX_STATS["iters"] / RELAX_STATS["attempts"]``
(ops/relax.py ``joint_relax_plan``); the ring repeats, so this is the
window's mean. Nothing where the program keeps no such count or the rung
never ran."""


def read(ctx):
    from karpenter_tpu_torch.ops.relax import RELAX_STATS

    attempts, iters = RELAX_STATS.get("attempts"), RELAX_STATS.get("iters")
    if not attempts or iters is None:
        return None
    return iters / attempts
