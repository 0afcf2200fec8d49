"""The generator: determinism per seed, and the frozen copies against the
program's own generators at a seed."""

from __future__ import annotations

import json

import pytest

from portbench import gen
from portbench.tests.conftest import ROOT

GIB = 2**30


def _load(kind, name):
    return json.loads((ROOT / "portbench" / kind / f"{name}.json").read_text())


@pytest.mark.parametrize("mix", ["burst-50k", "diverse-500", "generic-500"])
def test_ring_is_deterministic_per_seed(mix):
    traffic = dict(_load("traffic", mix), pods=300)
    seed = 2**31 + 977
    assert gen.ring(traffic, seed) == gen.ring(traffic, seed)
    other = gen.ring(traffic, seed + 1)
    assert other != gen.ring(traffic, seed)
    # every seed does the same work: the same sizes in each batch of the
    # ring, in another order
    sizes = lambda ring: sorted(  # noqa: E731
        sorted((p["cpu"], p["mem"]) for p in b) for b in ring)
    assert sizes(other) == sizes(gen.ring(traffic, seed))


def test_negative_and_huge_seeds():
    traffic = dict(_load("traffic", "generic-500"), pods=50)
    for seed in (-5, 0, 2**70 + 3):
        assert gen.ring(traffic, seed) == gen.ring(traffic, seed)
    assert gen.ring(traffic, -5) != gen.ring(traffic, 5)


def test_catalog_is_benchmark_catalog():
    from karpenter_tpu_torch.cloudprovider.catalog import benchmark_catalog

    from portbench import system

    cfg = _load("configs", "burst-500types")
    plain = gen.catalog(cfg)
    theirs = benchmark_catalog(cfg["catalog"]["types"])
    ours = system.instance_types(cfg, plain)
    assert len(ours) == len(theirs) == cfg["catalog"]["types"]
    for a, b in zip(ours, theirs):
        assert a.name == b.name
        assert a.capacity == b.capacity
        assert a.allocatable() == b.allocatable()
        assert a.requirements == b.requirements
        assert [(o.zone, o.capacity_type, o.price, o.available)
                for o in a.offerings] == [
            (o.zone, o.capacity_type, o.price, o.available) for o in b.offerings]


def test_catalog_is_fake_instance_types():
    """Upstream's ``fake.InstanceTypes(400)``: type i has i + 1 vCPU,
    2(i + 1) GiB and 10(i + 1) pods, spot in two zones and on-demand in
    three at ``PriceFromResources``, kube-reserved 100m and 10Mi; the
    program's objects say the same."""
    from portbench import system
    from portbench.reference import judge as ref

    cfg = _load("configs", "upstream-400types")
    plain = gen.catalog(cfg)
    assert len(plain) == 400
    for i in (0, 1, 2, 399):
        t = plain[i]
        assert (t["name"], t["cpu"], t["mem_gib"], t["pods"], t["arch"]) == (
            f"fake-it-{i}", i + 1, 2 * (i + 1), 10 * (i + 1), "amd64")
        assert t["price"] == pytest.approx(0.025 * (i + 1) + 0.001 * 2 * (i + 1) * GIB / 1e9)
        assert sorted(map(tuple, t["offerings"])) == [
            ("on-demand", "test-zone-1"), ("on-demand", "test-zone-2"),
            ("on-demand", "test-zone-3"), ("spot", "test-zone-1"),
            ("spot", "test-zone-2")]
    cat = ref.Catalog(cfg, plain)
    ours = system.instance_types(cfg, plain)
    for t, it, cpu_m, mem in zip(plain, ours, cat.alloc_cpu, cat.alloc_mem):
        assert it.name == t["name"]
        alloc = it.allocatable()
        assert round(alloc["cpu"] * 1000) == cpu_m == t["cpu"] * 1000 - 100
        assert alloc["memory"] == mem == t["mem_gib"] * GIB - 10 * 2**20
        assert alloc["pods"] == t["pods"]
        assert sorted((o.capacity_type, o.zone, o.price) for o in it.offerings) == sorted(
            (c, z, t["price"]) for c, z in t["offerings"])


def test_shapes_are_the_headline():
    from karpenter_tpu_torch.workload import build_workload

    from portbench import system

    traffic = dict(_load("traffic", "burst-50k"), pods=240, counts="cycle")
    pods = system.pods(gen.batch(traffic, 1))
    theirs, _, _ = build_workload(n_pods=240, n_types=10)
    assert [(p.name, p.requests, p.node_selector) for p in pods] == [
        (p.name, p.requests, p.node_selector) for p in theirs]


@pytest.mark.parametrize("seed", [42, 7, 2**40 + 1])
def test_mix_is_diverse_pods(seed):
    from karpenter_tpu_torch.workload import diverse_pods

    from portbench import system

    traffic = dict(_load("traffic", "diverse-500"), pods=131)
    ours = system.pods(gen.batch(traffic, seed))
    theirs = diverse_pods(131, seed)

    def key(p):
        aff = p.affinity
        terms = lambda pa: [  # noqa: E731
            (t.topology_key, t.label_selector.match_labels)
            for t in (pa.required if pa else [])]
        return (p.name, p.requests, p.metadata.labels, p.node_selector,
                [(s.max_skew, s.topology_key, s.when_unsatisfiable,
                  s.label_selector.match_labels)
                 for s in p.topology_spread_constraints],
                terms(aff.pod_affinity) if aff else [],
                terms(aff.pod_anti_affinity) if aff else [])

    assert [key(p) for p in ours] == [key(p) for p in theirs]


def test_generic_mix_is_the_generic_part():
    traffic = _load("traffic", "generic-500")
    pods = gen.batch(traffic, 3)
    assert len(pods) == 500
    assert all(not p["spread"] and not p["affinity"] and not p["anti"]
               and set(p["labels"]) == {"my-label"} for p in pods)
