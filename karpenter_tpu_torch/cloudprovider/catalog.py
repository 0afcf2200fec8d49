"""Synthetic instance-type catalog generator.

Plays the role of the reference's kwok catalog (kwok/cloudprovider/
instance_types.json, generated by kwok/tools/gen_instance_types.go:57-62:
families x cpu sizes x arch x linux, 4 zones x {spot, on-demand}, price
linear in cpu/memory) and of fake.InstanceTypes(n)
(pkg/cloudprovider/fake/instancetype.go) for tests and benchmarks.
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.cloudprovider.types import (
    InstanceType,
    InstanceTypeOverhead,
    Offering,
    Offerings,
)
from karpenter_tpu_torch.scheduling import IN, Requirement, Requirements

GIB = 2**30

# family -> GiB of memory per vCPU
FAMILIES = {"c": 2, "s": 4, "m": 8, "e": 16}
DEFAULT_CPUS = (1, 2, 4, 8, 16, 32, 48, 64)
DEFAULT_ZONES = ("zone-1", "zone-2", "zone-3", "zone-4")
DEFAULT_ARCHS = (wk.ARCHITECTURE_AMD64, wk.ARCHITECTURE_ARM64)

INSTANCE_FAMILY_LABEL = "karpenter.tpu/instance-family"
INSTANCE_CPU_LABEL = "karpenter.tpu/instance-cpu"
INSTANCE_MEMORY_LABEL = "karpenter.tpu/instance-memory"

# synthetic pricing basis (kwok gen_instance_types.go:57-62 uses a similar
# linear model); spot trades at a discount
CPU_HOURLY = 0.025
MEM_GIB_HOURLY = 0.001
SPOT_DISCOUNT = 0.7

# seeded interruption-risk band for generated spot offerings: real spot
# markets reclaim suspiciously-cheap capacity first, so the synthetic
# signal is deterministic per (type, zone) — stable across processes,
# seeds the chaos storm's notice sampling, and stays inert until
# KARPENTER_SPOT_RISK_LAMBDA > 0 (types.effective_price)
SEEDED_RISK_LO = 0.02
SEEDED_RISK_HI = 0.60


def seeded_risk(name: str, zone: str) -> float:
    """Deterministic per-(type, zone) spot interruption risk in
    [SEEDED_RISK_LO, SEEDED_RISK_HI] — a hash, not a RNG, so the kwok and
    fake providers emit the SAME signal in every process (the
    provider-pluggable analog of a real provider's capacity-pool score)."""
    import zlib

    h = zlib.crc32(f"{name}/{zone}".encode()) & 0xFFFFFFFF
    return round(
        SEEDED_RISK_LO + (SEEDED_RISK_HI - SEEDED_RISK_LO) * (h / 0xFFFFFFFF),
        6,
    )


def price_of(cpu: float, mem_gib: float, capacity_type: str) -> float:
    p = cpu * CPU_HOURLY + mem_gib * MEM_GIB_HOURLY
    return round(p * (SPOT_DISCOUNT if capacity_type == wk.CAPACITY_TYPE_SPOT else 1.0), 6)


def make_instance_type(
    name: str,
    cpu: float,
    mem_gib: float,
    arch: str = wk.ARCHITECTURE_AMD64,
    zones=DEFAULT_ZONES,
    capacity_types=(wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND),
    family: str | None = None,
    pods: int = 110,
    extra_capacity: dict | None = None,
    extra_requirements=(),
    price_override: float | None = None,
    os: str = "linux",
    spot_risk="seeded",
    spot_price_by_zone: dict | None = None,
) -> InstanceType:
    """``spot_risk`` sets the spot offerings' interruption-risk signal:
    the default ``"seeded"`` emits the deterministic :func:`seeded_risk`
    hash (the kwok/fake contract), a float applies uniformly, a dict maps
    zone → risk (``None`` values = unknown), and ``None`` leaves every
    spot offering's risk UNKNOWN. On-demand offerings always carry risk
    0.0 (known-stable). ``spot_price_by_zone`` overrides the spot price
    per zone (the chaos storm's risk-correlated price surface)."""
    reqs = Requirements(
        Requirement(wk.INSTANCE_TYPE_LABEL, IN, [name]),
        Requirement(wk.ARCH_LABEL, IN, [arch]),
        Requirement(wk.OS_LABEL, IN, [os]),
        Requirement(wk.TOPOLOGY_ZONE_LABEL, IN, list(zones)),
        Requirement(wk.CAPACITY_TYPE_LABEL, IN, list(capacity_types)),
        Requirement(INSTANCE_CPU_LABEL, IN, [str(int(cpu))]),
        Requirement(INSTANCE_MEMORY_LABEL, IN, [str(int(mem_gib * 1024))]),
        *extra_requirements,
    )
    if family:
        reqs.add(Requirement(INSTANCE_FAMILY_LABEL, IN, [family]))
    offerings = Offerings()
    for ct in capacity_types:
        for zone in zones:
            if ct == wk.CAPACITY_TYPE_SPOT:
                if spot_risk == "seeded":
                    risk = seeded_risk(name, zone)
                elif isinstance(spot_risk, dict):
                    risk = spot_risk.get(zone)
                else:
                    risk = spot_risk  # fixed float, or None = unknown
            else:
                risk = 0.0  # on-demand: known-stable
            price = price_override if price_override is not None else price_of(cpu, mem_gib, ct)
            if ct == wk.CAPACITY_TYPE_SPOT and spot_price_by_zone:
                price = spot_price_by_zone.get(zone, price)
            offerings.append(
                Offering(
                    requirements=Requirements(
                        Requirement(wk.CAPACITY_TYPE_LABEL, IN, [ct]),
                        Requirement(wk.TOPOLOGY_ZONE_LABEL, IN, [zone]),
                    ),
                    price=price,
                    available=True,
                    interruption_risk=risk,
                )
            )
    capacity = {
        "cpu": float(cpu),
        "memory": mem_gib * GIB,
        "ephemeral-storage": 20 * GIB,
        "pods": float(pods),
    }
    capacity.update(extra_capacity or {})
    overhead = InstanceTypeOverhead(
        kube_reserved={"cpu": min(0.1, cpu * 0.01), "memory": 0.05 * mem_gib * GIB}
    )
    return InstanceType(name, reqs, offerings, capacity, overhead)


KWOK_CPUS = (1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256)
KWOK_MEM_FACTORS = {2: "c", 4: "s", 8: "m"}  # memFactor -> family
KWOK_OSES = ("linux", "windows")


def kwok_catalog(
    cpus=KWOK_CPUS, archs=DEFAULT_ARCHS, zones=DEFAULT_ZONES, oses=KWOK_OSES
) -> list:
    """The 144-entry generated catalog, mirroring the kwok provider's
    generator (kwok/tools/gen_instance_types.go:71-113): cpu sizes ×
    mem-factor families (c/s/m) × os × arch, each with 4-zone × spot/
    on-demand offerings, pods capped at min(16·cpu, 1024), synthetic
    linear pricing with a 0.7 spot discount."""
    out = []
    for cpu in cpus:
        for factor, fam in KWOK_MEM_FACTORS.items():
            for os in oses:
                for arch in archs:
                    out.append(
                        make_instance_type(
                            f"{fam}-{cpu}x-{arch}-{os}",
                            cpu=cpu,
                            mem_gib=cpu * factor,
                            arch=arch,
                            zones=zones,
                            family=fam,
                            pods=min(cpu * 16, 1024),
                            os=os,
                        )
                    )
    return out


def benchmark_catalog(n: int = 400, zones=DEFAULT_ZONES) -> list:
    """Size-diverse n-type catalog in the spirit of fake.InstanceTypes(n):
    cycles cpu/memory shapes so sizes are non-uniform."""
    out = []
    cpus = (1, 2, 4, 8, 16, 32, 64)
    ratios = (2, 4, 8)
    i = 0
    while len(out) < n:
        cpu = cpus[i % len(cpus)]
        ratio = ratios[(i // len(cpus)) % len(ratios)]
        arch = DEFAULT_ARCHS[(i // (len(cpus) * len(ratios))) % 2]
        name = f"fake-it-{i}"
        out.append(
            make_instance_type(
                name,
                cpu=cpu,
                mem_gib=cpu * ratio,
                arch=arch,
                zones=zones,
                family="fake",
                # mild price jitter so orderings are strict but stable
                price_override=price_of(cpu, cpu * ratio, wk.CAPACITY_TYPE_ON_DEMAND)
                * (1.0 + (i % 13) * 0.003),
            )
        )
        i += 1
    return out
