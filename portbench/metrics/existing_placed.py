"""``existing_placed``: the pods a device solve commits onto existing
nodes, per solve over existing nodes in the process,
``STATS["existing_placed"] / STATS["existing_solves"]`` (ops/tensorize.py,
counted in models/solver.py ``solve``); the ring repeats, so this is the
window's mean. Nothing where the program keeps no such count or no solve
ran over existing nodes."""


def read(ctx):
    from karpenter_tpu_torch.ops.tensorize import STATS

    solves, placed = STATS.get("existing_solves"), STATS.get("existing_placed")
    if not solves or placed is None:
        return None
    return placed / solves
