"""The general generator: configurations and traffic mixes as plain data.

Everything here is plain Python and NumPy, read from the JSON files under
``portbench/configs/`` and ``portbench/traffic/``; nothing imports the
program. The program's objects are built from these dicts by
``portbench/system.py``, and the plain reference (``portbench/reference/``)
judges the program's answers against the same dicts.

Frozen copies, so that a later change to the program cannot move the
yardstick:

- ``catalog``: the cycle of ``benchmark_catalog(n)`` and the defaults of
  ``make_instance_type`` (``karpenter_tpu_torch/cloudprovider/catalog.py``),
  with their prices and kube-reserved overhead; and upstream's
  ``fake.InstanceTypes(n)`` (``pkg/cloudprovider/fake/instancetype.go``),
  which the program has no copy of.
- ``shapes`` traffic: the headline's 24 deployment shapes
  (``karpenter_tpu_torch/workload.py`` ``build_workload``, after
  ``bench.py:90``).
- ``mix`` traffic: upstream's ``makeDiversePods`` and its generic pods, in
  the draw order of ``karpenter_tpu_torch/workload.py`` ``diverse_pods``
  (``scheduling_benchmark_test.go`` makeDiversePods:234-248, the seeded
  generators :250-363).

A plain pod is a dict: ``name``, ``cpu`` (cores), ``mem`` (bytes, an
integer), ``labels``, ``selector`` (a node selector), ``spread``
(``[{"key", "skew", "match"}]``), ``affinity`` and ``anti`` (``[{"key",
"match"}]``, required pod (anti-)affinity), and ``stamp``: pods of one
stamp are replicas of one deployment and share their spec objects.
"""

from __future__ import annotations

import random

import numpy as np

GIB = 2**30
MIB = 2**20


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """A NumPy generator for ``seed`` (any whole number, negative or past
    64 bits) and a salt such as a batch index."""
    words = [abs(seed) & 0xFFFFFFFFFFFFFFFF, abs(seed) >> 64, int(seed < 0)]
    return np.random.default_rng(np.random.SeedSequence(words + list(salt)))


# --------------------------------------------------------------------------
# the catalog


def catalog(cfg: dict) -> list:
    """The configuration's instance types as plain dicts: ``name``,
    ``cpu``, ``mem_gib``, ``pods`` (the pod capacity), ``arch``, ``oses``,
    ``offerings`` (``[capacity type, zone]`` pairs), ``zones`` and
    ``capacity_types`` (those of the offerings), ``labels`` (the type's
    further labels, one value each), ``ephemeral`` (bytes, or None where
    the type states none) and ``price`` (every offering's hourly price).
    The configuration's ``catalog.kind`` names the formula."""
    cat = cfg["catalog"]
    kind = cat["kind"]
    if kind == "benchmark_catalog":
        return _benchmark_catalog(cat)
    if kind == "fake_instance_types":
        return _fake_instance_types(cat)
    raise ValueError(f"unknown catalog kind {kind!r}")


def _type(name, cpu, mem_gib, pods, arch, oses, offerings, labels, ephemeral,
          price) -> dict:
    return {"name": name, "cpu": cpu, "mem_gib": mem_gib, "pods": pods,
            "arch": arch, "oses": list(oses),
            "offerings": [list(o) for o in offerings],
            "zones": list(dict.fromkeys(z for _, z in offerings)),
            "capacity_types": list(dict.fromkeys(c for c, _ in offerings)),
            "labels": labels, "ephemeral": ephemeral, "price": price}


def _benchmark_catalog(cat: dict) -> list:
    """``benchmark_catalog(n)``'s cycle: cpu sizes, then memory ratios,
    then architectures, each type's price the on-demand list price
    (``catalog.py`` ``price_of``) times a jitter of ``1 + (i % 13) *
    0.003``, the same for every offering; every zone × capacity type."""
    cpus, ratios, archs = cat["cpus"], cat["ratios"], cat["archs"]
    offerings = [(c, z) for c in cat["capacity_types"] for z in cat["zones"]]
    out = []
    for i in range(cat["types"]):
        cpu = cpus[i % len(cpus)]
        ratio = ratios[(i // len(cpus)) % len(ratios)]
        arch = archs[(i // (len(cpus) * len(ratios))) % len(archs)]
        mem_gib = cpu * ratio
        price = round(cpu * cat["cpu_hourly"] + mem_gib * cat["mem_gib_hourly"], 6) * (
            1.0 + (i % cat["jitter_cycle"]) * cat["jitter_step"])
        labels = {k: v.format(cpu=int(cpu), mem_mib=int(mem_gib * 1024),
                              family=cat["family"])
                  for k, v in cat["labels"].items()}
        out.append(_type(f"{cat['prefix']}{i}", cpu, mem_gib, cat["pods_per_node"],
                         arch, [cat["os"]], offerings, labels,
                         cat["ephemeral_gib"] * GIB, price))
    return out


def _fake_instance_types(cat: dict) -> list:
    """Upstream's ``fake.InstanceTypes(n)`` (``pkg/cloudprovider/fake/
    instancetype.go``): type i has i + 1 vCPU, 2(i + 1) GiB and 10(i + 1)
    pods, and ``NewInstanceType``'s defaults: amd64, the three operating
    systems, spot in two zones and on-demand in three, and every offering
    at ``PriceFromResources``: 0.025 an hour a vCPU and 0.001 a 10^9 bytes
    of memory."""
    out = []
    for i in range(cat["types"]):
        n = i + 1
        cpu, mem_gib, pods = n * cat["cpu_step"], n * cat["mem_gib_step"], n * cat["pods_step"]
        price = cpu * cat["cpu_hourly"] + cat["mem_gb_hourly"] * mem_gib * GIB / 1e9
        labels = {k: v.format(cpu=int(cpu)) for k, v in cat["labels"].items()}
        out.append(_type(f"{cat['prefix']}{i}", cpu, mem_gib, pods, cat["arch"],
                         cat["oses"], cat["offerings"], labels, None, price))
    return out


# --------------------------------------------------------------------------
# traffic


def ring(traffic: dict, seed: int) -> list:
    """The ring of distinct batches a run cycles. The traffic is fixed:
    batch i of every run is ``batch(traffic, i + 1)``, so that every run
    does the same work; the run's seed draws only the order in which the
    ring is decided (and, in ``run.py``, which decisions are judged)."""
    order = rng_for(seed, 0x5EED).permutation(traffic["ring"]).tolist()
    return [batch(traffic, index + 1) for index in order]


def batch(traffic: dict, seed: int, index: int = 0) -> list:
    """One batch of plain pods of the mix ``traffic`` from ``seed``."""
    kind = traffic["generator"]
    if kind == "shapes":
        return _shapes(traffic, seed)
    if kind == "mix":
        return _mix(traffic, seed)
    raise ValueError(f"unknown traffic generator {kind!r}")


def _shapes(traffic: dict, seed: int) -> list:
    """Deployment replicas over the product of sizes × selectors. With
    ``counts: "cycle"`` pod i takes shape ``i % S`` (the headline's
    order); with ``"multinomial"`` the count of each shape is drawn from
    the seed with equal odds and the pods come shape by shape, each shape's
    replicas in a row."""
    shapes = [(cpu, mem, sel) for cpu, mem in traffic["sizes"]
              for sel in traffic["selectors"]]
    n = traffic["pods"]
    if traffic["counts"] == "cycle":
        order = [i % len(shapes) for i in range(n)]
    elif traffic["counts"] == "multinomial":
        counts = rng_for(seed, 1).multinomial(n, [1.0 / len(shapes)] * len(shapes))
        order = np.repeat(np.arange(len(shapes)), counts).tolist()
    else:
        raise ValueError(f"unknown counts {traffic['counts']!r}")
    return [_plain(f"p{i}", shapes[s][0], int(shapes[s][1] * GIB), _NONE,
                   selector=shapes[s][2], stamp=s) for i, s in enumerate(order)]


_NONE: dict = {}


def _plain(name, cpu, mem, labels, selector=_NONE, spread=(), affinity=(),
           anti=(), stamp=None) -> dict:
    """One plain pod; its dicts and lists are shared, never written."""
    return {"name": name, "cpu": cpu, "mem": mem, "labels": labels,
            "selector": selector, "spread": spread, "affinity": affinity,
            "anti": anti, "stamp": stamp}


def _mix(traffic: dict, seed: int) -> list:
    """Upstream's ``makeDiversePods``: the parts in order, each
    ``pods // len(parts)`` pods named ``<prefix>-<i>``, then generic pods
    to fill. Every random draw is ``diverse_pods``'s, in its order, from
    ``random.Random(seed)``."""
    r = random.Random(seed)
    values, cpus, mems = traffic["values"], traffic["cpus"], traffic["mems_mi"]
    label_key, aff_key = traffic["label_key"], traffic["affinity_label_key"]

    def requests():
        return r.choice(cpus), r.choice(mems) * MIB

    def labels(key):
        return {key: r.choice(values)}

    pods: list = []
    count = traffic["pods"]
    share = count // len(traffic["parts"])
    parts = [(part, share) for part in traffic["parts"]]
    for (kind, prefix, topo_key), n in parts + [(("generic", traffic["fill"], None), None)]:
        if n is None:
            n = count - len(pods)
        for i in range(n):
            cpu, mem = requests()
            name = f"{prefix}-{i}"
            if kind == "generic":
                pods.append(_plain(name, cpu, mem, labels(label_key)))
            elif kind == "spread":
                own = labels(label_key)
                pods.append(_plain(name, cpu, mem, own, spread=[{
                    "key": topo_key, "skew": 1, "match": labels(label_key)}]))
            elif kind == "affinity":
                own = labels(aff_key)
                pods.append(_plain(name, cpu, mem, own, affinity=[{
                    "key": topo_key, "match": labels(aff_key)}]))
            elif kind == "anti":
                cohort = dict(traffic["anti_labels"])
                pods.append(_plain(name, cpu, mem, dict(cohort), anti=[{
                    "key": topo_key, "match": dict(cohort)}]))
            else:
                raise ValueError(f"unknown part {kind!r}")
    return pods
