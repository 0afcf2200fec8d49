"""The live kind's plain generator: a running cluster and a burst of
pending pods, as data.

Plain Python and NumPy; nothing imports the program. A ring input is a
fleet of ``fleet.py`` (``nodes`` nodes, each launched for
``deployments_per_node`` deployments of ``replicas_before`` of upstream's
generic pods and running ``replicas`` of each: with the two equal, no
deployment was scaled down) and a burst of ``gen._mix``'s pods of the mix
keys (upstream's ``makeDiversePods``). The running pods carry the label
upstream's ``makeGenericPods`` gives its pods: one value of
``label_key`` a deployment, drawn from ``values`` with equal odds after
``fleet.fleet``'s own draws, from a salt of its own, so that
``fleet.py``'s output for its own cells is unchanged. The burst's spread
and affinity selectors select on that label, so the running pods count
in their nodes' domains.

A plain input is a dict: ``index`` (the ring's input), ``pool``,
``nodes`` and ``pods`` (the running cluster, as ``fleet.fleet`` gives
them, each pod with its ``labels``) and ``burst`` (``gen``'s plain pods,
pending).
"""

from __future__ import annotations

from portbench import fleet, gen
from portbench.reference import judge as ref

LABEL_SALT = 0x1AB1


def ring(cfg: dict, plain_catalog: list, traffic: dict, seed: int) -> list:
    """The ring of inputs a run cycles: input i is ``live(..., i + 1)``
    in every run; the run's seed draws only their order."""
    cat = ref.Catalog(cfg, plain_catalog)
    order = gen.rng_for(seed, 0x5EED).permutation(traffic["ring"]).tolist()
    return [live(cfg, cat, traffic, index + 1) for index in order]


def live(cfg: dict, cat: ref.Catalog, traffic: dict, index: int) -> dict:
    """Input ``index`` of the mix ``traffic``: the fleet and the burst
    drawn from seed ``index``."""
    plain = fleet.fleet(cfg, cat, traffic, index)
    deployments = list(dict.fromkeys(p["deployment"] for p in plain["pods"]))
    drawn = gen.rng_for(index, LABEL_SALT).integers(
        len(traffic["values"]), size=len(deployments)).tolist()
    labels = {d: {traffic["label_key"]: traffic["values"][v]}
              for d, v in zip(deployments, drawn)}
    pods = [dict(p, labels=labels[p["deployment"]]) for p in plain["pods"]]
    return {"index": index, "pool": plain["pool"], "nodes": plain["nodes"],
            "pods": pods, "burst": gen._mix(traffic, index)}
