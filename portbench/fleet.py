"""The consolidation kind's plain generator: underutilized fleets as data.

Plain Python and NumPy; nothing imports the program. A fleet is ``nodes``
nodes, each launched for ``deployments_per_node`` deployments of
``replicas_before`` replicas and left holding ``replicas`` of each after
the deployments were scaled down (``BASELINE.json`` config 4's rule, the
JAX package's ``perf/configs.py:107`` ``config4_consolidation_env``: three
replicas on a node sized for them, scaled to one). Each deployment's pod
is one of upstream's generic pods (``makeGenericPods`` in
``scheduling_benchmark_test.go``): its cpu and its memory drawn apart from
``cpus`` and ``mems_mi`` with equal odds, from the fleet's seed.

A node is sized as kwok's ``create`` sizes a claim for the pods it held
(``karpenter_tpu_torch/cloudprovider/kwok.py``, its
``cheapest_effective_offering`` at λ 0): the first type, in catalog
order, of the least price among the highest-weight NodePool's types whose
exact allocatable holds the claim's pods in milli-cpu, bytes and pod
slots, and that type's first offering.

A plain fleet is a dict: ``index`` (the ring's batch), ``pool``, ``nodes``
(``name``, ``type``, ``zone``, ``capacity_type``, ``pool``, ``pods``: the
names of the pods it holds, ``sized_for``: the requests its claim was
sized for) and ``pods`` (``gen``'s plain pods, each with its ``node`` and
``deployment``).
"""

from __future__ import annotations

import numpy as np

from portbench import gen
from portbench.reference import judge as ref


def ring(cfg: dict, plain_catalog: list, traffic: dict, seed: int) -> list:
    """The ring of fleets a run cycles: fleet i is ``fleet(..., i + 1)``
    in every run; the run's seed draws only their order."""
    cat = ref.Catalog(cfg, plain_catalog)
    order = gen.rng_for(seed, 0x5EED).permutation(traffic["ring"]).tolist()
    return [fleet(cfg, cat, traffic, index + 1) for index in order]


def pool(cfg: dict) -> dict:
    """The highest-weight NodePool (the first by name among equals)."""
    return min(cfg["nodepools"], key=lambda p: (-p["weight"], p["name"]))


def size_node(cat: ref.Catalog, pool_name: str, cpu_m: int, mem: int, pods: int):
    """``(type index, (capacity type, zone))`` of the node launched for
    pods requesting ``cpu_m`` milli-cpu, ``mem`` bytes and ``pods`` slots,
    or None where no type holds them."""
    reqs = {ref.NODEPOOL: [False, [pool_name]]}
    fits = (cat.alloc_cpu >= cpu_m) & (cat.alloc_mem >= mem) & (cat.slots >= pods)
    ok = np.flatnonzero(cat.compatible(reqs) & fits)
    if ok.size == 0:
        return None
    best = min(ok.tolist(), key=lambda i: (cat.price[i], i))
    return best, cat.offerings[best][0]


def fleet(cfg: dict, cat: ref.Catalog, traffic: dict, index: int) -> dict:
    """Fleet ``index`` of the mix ``traffic`` (drawn from seed ``index``)."""
    p = pool(cfg)
    n, d = traffic["nodes"], traffic["deployments_per_node"]
    before, kept = traffic["replicas_before"], traffic["replicas"]
    cpus, mems = traffic["cpus"], traffic["mems_mi"]
    rng = gen.rng_for(index, 1)
    ci = rng.integers(len(cpus), size=(n, d))
    mi = rng.integers(len(mems), size=(n, d))
    milli = np.array([ref._milli(c) for c in cpus], dtype=np.int64)
    mem_b = np.array(mems, dtype=np.int64) * gen.MIB
    need_cpu = before * milli[ci].sum(1)
    need_mem = before * mem_b[mi].sum(1)
    nodes, pods = [], []
    for j in range(n):
        sized = size_node(cat, p["name"], int(need_cpu[j]), int(need_mem[j]), before * d)
        if sized is None:
            raise ValueError(f"no type holds node {j}'s {before * d} pods")
        t, (ct, zone) = sized
        node = f"{p['name']}-{index}-{j:05d}"
        names = []
        for k in range(d):
            deployment = f"d{index}-{j:05d}-{k}"
            shape = gen._plain("", cpus[ci[j, k]], int(mem_b[mi[j, k]]), gen._NONE,
                               stamp=int(ci[j, k] * len(mems) + mi[j, k]))
            for r in range(kept):
                name = f"{deployment}-{r}"
                names.append(name)
                pods.append(dict(shape, name=name, node=node, deployment=deployment))
        nodes.append({"name": node, "type": cat.names[t], "zone": zone,
                      "capacity_type": ct, "pool": p["name"], "pods": names,
                      "sized_for": {"cpu": int(need_cpu[j]) / 1000,
                                    "mem": int(need_mem[j]), "pods": before * d}})
    return {"index": index, "pool": p["name"], "nodes": nodes, "pods": pods}
