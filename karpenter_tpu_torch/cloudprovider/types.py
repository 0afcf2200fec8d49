"""Cloud-provider SPI: the only seam to the outside world.

Semantics from the reference's pkg/cloudprovider/types.go: the CloudProvider
interface :46-69, InstanceType/Offerings catalog model :73-102/:214-297,
SatisfiesMinValues :165-199, Truncate :203-212, and the typed errors
:299-387. The catalog model doubles as the source for the device-side
allocatable/price tensors (ops/tensorize.py).

Interruption-risk contract (spot resilience, deploy/README.md "Spot
resilience"): every :class:`Offering` may carry a per-offering
``interruption_risk`` signal in [0, 1] — the provider's estimate of the
probability the capacity is reclaimed within the planning horizon.
``None`` means UNKNOWN (no signal; consumers must stay conservative —
under λ > 0 an unknown risk prices at the ``KARPENTER_SPOT_RISK_DEFAULT``
prior so unscored capacity is never systematically preferred), ``0.0``
means known-stable (on-demand). The risk never gates feasibility;
it discounts price: :func:`effective_price` is
``price × (1 + λ·risk)`` with ``λ = KARPENTER_SPOT_RISK_LAMBDA``
(default 0 — risk-blind, bit-identical to nominal pricing). The same
formula is tensorized into the device price matrices at snapshot build
(ops/tensorize.py), so provisioning, the consolidation probe ladders,
and the replacement price filters are all risk-aware through ONE number,
with zero new dispatch paths. Interruption NOTICES (the two-minute
warning) arrive through :meth:`CloudProvider.interruption_notices`; the
disruption controller marks the node and the ``InterruptionDrain``
method drains it proactively (controllers/disruption/methods.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.scheduling import Requirement, Requirements, IN
from karpenter_tpu_torch.utils import resources as resutil

SPOT_REQUIREMENT = Requirements(Requirement(wk.CAPACITY_TYPE_LABEL, IN, [wk.CAPACITY_TYPE_SPOT]))
ON_DEMAND_REQUIREMENT = Requirements(
    Requirement(wk.CAPACITY_TYPE_LABEL, IN, [wk.CAPACITY_TYPE_ON_DEMAND])
)


@dataclass
class Offering:
    """One (zone, capacity-type) purchase option (types.go:214-225).

    ``interruption_risk`` is the provider's per-offering reclaim-risk
    signal in [0, 1]; ``None`` = unknown (module docstring contract)."""

    requirements: Requirements
    price: float
    available: bool = True
    interruption_risk: float | None = None

    @property
    def zone(self) -> str:
        r = self.requirements.get_req(wk.TOPOLOGY_ZONE_LABEL)
        return next(iter(r.values), "") if not r.complement else ""

    @property
    def capacity_type(self) -> str:
        r = self.requirements.get_req(wk.CAPACITY_TYPE_LABEL)
        return next(iter(r.values), "") if not r.complement else ""


def risk_lambda() -> float:
    """The risk-discount weight λ (``KARPENTER_SPOT_RISK_LAMBDA``, ≥ 0;
    default 0 = risk-blind). Read per call so a perf harness can flip it
    between legs without rebuilding the process."""
    from karpenter_tpu_torch.utils.envknobs import env_float

    return env_float("KARPENTER_SPOT_RISK_LAMBDA", 0.0, minimum=0.0)


def default_risk() -> float:
    """The prior an UNKNOWN risk (``interruption_risk=None``) prices at
    under λ > 0 (``KARPENTER_SPOT_RISK_DEFAULT``, default 0). Without a
    prior, unscored capacity would price as known-stable and every λ > 0
    consumer would systematically anti-select TOWARD the pools the
    provider could not vouch for; operators on partially-instrumented
    providers set a mid-band prior (e.g. 0.3) to keep the conservative
    stance. The default stays 0 so the λ=0 parity and existing λ > 0
    behavior are unchanged unless opted in."""
    from karpenter_tpu_torch.utils.envknobs import env_float

    return env_float("KARPENTER_SPOT_RISK_DEFAULT", 0.0, minimum=0.0)


def effective_price(offering: Offering, lam: float | None = None) -> float:
    """Risk-discounted effective price: ``price × (1 + λ·risk)``.

    λ=0 (the default) — or a zero risk — returns the nominal price
    UNCHANGED (the same float object path, no multiply), which is what
    makes the λ=0 parity pin exact: a risk-bearing catalog under λ=0
    prices bit-identically to a risk-free one. An UNKNOWN risk prices at
    the :func:`default_risk` prior (default 0)."""
    if lam is None:
        lam = risk_lambda()
    if lam <= 0.0:
        return offering.price
    risk = offering.interruption_risk
    if risk is None:
        risk = default_risk()
    if not risk:
        return offering.price
    return offering.price * (1.0 + lam * risk)


class Offerings(list):
    def available(self) -> "Offerings":
        return Offerings(o for o in self if o.available)

    def compatible(self, reqs: Requirements) -> "Offerings":
        return Offerings(
            o
            for o in self
            if reqs.is_compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS)
        )

    def has_compatible(self, reqs: Requirements) -> bool:
        return any(
            reqs.is_compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS) for o in self
        )

    def cheapest(self) -> Offering:
        return min(self, key=lambda o: o.price)

    def most_expensive(self) -> Offering:
        return max(self, key=lambda o: o.price)

    def worst_launch_price(self, reqs: Requirements) -> float:
        """Spot-aware worst-case launch price (types.go:276-297)."""
        if reqs.get_req(wk.CAPACITY_TYPE_LABEL).has(wk.CAPACITY_TYPE_SPOT):
            spot = self.compatible(reqs).compatible(SPOT_REQUIREMENT)
            if spot:
                return spot.most_expensive().price
        if reqs.get_req(wk.CAPACITY_TYPE_LABEL).has(wk.CAPACITY_TYPE_ON_DEMAND):
            od = self.compatible(reqs).compatible(ON_DEMAND_REQUIREMENT)
            if od:
                return od.most_expensive().price
        return math.inf


@dataclass
class InstanceTypeOverhead:
    kube_reserved: dict = field(default_factory=dict)
    system_reserved: dict = field(default_factory=dict)
    eviction_threshold: dict = field(default_factory=dict)

    def total(self) -> dict:
        return resutil.merge(self.kube_reserved, self.system_reserved, self.eviction_threshold)


class InstanceType:
    """Properties of a potential node (types.go:73-102)."""

    def __init__(
        self,
        name: str,
        requirements: Requirements,
        offerings: Offerings,
        capacity: dict,
        overhead: InstanceTypeOverhead | None = None,
    ):
        self.name = name
        self.requirements = requirements
        self.offerings = offerings
        self.capacity = capacity
        self.overhead = overhead or InstanceTypeOverhead()
        self._allocatable = None

    def allocatable(self) -> dict:
        if self._allocatable is None:
            self._allocatable = resutil.subtract(self.capacity, self.overhead.total())
        return self._allocatable

    def __repr__(self):
        return f"InstanceType({self.name})"


def _cheapest_available_price(it: InstanceType, reqs: Requirements,
                              lam: float | None = None) -> float:
    ofs = it.offerings.available().compatible(reqs)
    if not ofs:
        return math.inf
    # risk-aware: the ordering prefers low-risk capacity once λ > 0 and
    # is bit-identical to the nominal order at λ=0 (effective_price is
    # the identity there)
    if lam is None:
        lam = risk_lambda()
    return min(effective_price(o, lam) for o in ofs)


def order_by_price(its, reqs: Requirements) -> list:
    """Cheapest available+compatible offering first; name tiebreak
    (types.go OrderByPrice:104). Risk-aware through
    :func:`effective_price` (λ=0 keeps the nominal order); λ is read
    once per sort, not once per key evaluation."""
    lam = risk_lambda()
    return sorted(
        its,
        key=lambda it: (_cheapest_available_price(it, reqs, lam), it.name))


def cheapest_effective_offering(its, reqs: Requirements,
                                requests: dict | None = None):
    """``(InstanceType, Offering)`` with the minimal EFFECTIVE price
    among available offerings compatible with ``reqs`` (full per-type
    check incl. resource fit), or None. The ONE launch-placement rule the
    kwok and fake providers share: risk-aware under λ > 0, the nominal
    cheapest bit-identically at λ=0."""
    lam = risk_lambda()
    best = best_eff = None
    for it in its:
        if not instance_type_compatible(it, reqs, requests):
            continue
        for o in it.offerings.available().compatible(reqs):
            eff = effective_price(o, lam)
            if best is None or eff < best_eff:
                best, best_eff = (it, o), eff
    return best


def compatible_instance_types(its, reqs: Requirements) -> list:
    """Instance types with at least one available offering compatible with
    reqs (types.go Compatible:124)."""
    return [it for it in its if it.offerings.available().has_compatible(reqs)]


def instance_type_compatible(it: InstanceType, reqs: Requirements, requests: dict | None = None) -> bool:
    """Full per-type check used by the scheduler's filter
    (scheduling/nodeclaim.go filterInstanceTypesByRequirements:242):
    requirement overlap (two-way Intersects — custom labels the pod demands
    but the type doesn't define become node labels, so they don't filter
    here) ∧ resource fit ∧ an available compatible offering."""
    if it.requirements.intersects(reqs) is not None:
        return False
    if requests is not None and not resutil.fits(requests, it.allocatable()):
        return False
    return it.offerings.available().has_compatible(reqs)


def filter_instance_types(its, reqs: Requirements, requests: dict | None = None) -> list:
    return [it for it in its if instance_type_compatible(it, reqs, requests)]


def satisfies_min_values(its, reqs: Requirements):
    """(min needed instance types, error) per types.go:165-199 — walks the
    (pre-sorted) list accumulating distinct values per minValues key until
    every floor is met."""
    if not reqs.has_min_values():
        return 0, None
    values_for_key: dict = {}
    min_keys = [r.key for r in reqs.values() if r.min_values is not None]
    incompatible = None
    for i, it in enumerate(its):
        for key in min_keys:
            values_for_key.setdefault(key, set()).update(it.requirements.get_req(key).values)
        incompatible = next(
            (
                k
                for k in min_keys
                if len(values_for_key.get(k, ())) < (reqs.get_req(k).min_values or 0)
            ),
            None,
        )
        if incompatible is None:
            return i + 1, None
    return len(list(its)), f'minValues requirement is not met for "{incompatible}"'


def truncate_instance_types(its, reqs: Requirements, max_items: int):
    """(truncated list, error) — price-ordered prefix of max_items, rejected
    if it breaks minValues (types.go Truncate:203)."""
    truncated = order_by_price(its, reqs)[:max_items]
    if reqs.has_min_values():
        _, err = satisfies_min_values(truncated, reqs)
        if err:
            return list(its), f"validating minValues, {err}"
    return truncated, None


# ---------------------------------------------------------------------------
# typed errors (types.go:299-387)


class NodeClaimNotFoundError(Exception):
    pass


class InsufficientCapacityError(Exception):
    pass


class NodeClassNotReadyError(Exception):
    pass


class CatalogView:
    """The ONE node→(instance type, offering) resolution walk: nodepool
    label → pool → per-pool catalog memo → instance-type label →
    (zone, capacity-type) offering match. Shared by the chaos injector's
    risk sampling (cloudprovider/chaos.py), InterruptionDrain's rebuilt
    candidates (controllers/disruption/methods.py), and the perf
    harness's fleet-cost sweep (perf/run.py) so a catalog-shape change
    lands in one place. Memoizes one catalog list per pool per view —
    construct one per pass, not per node."""

    def __init__(self, pools, cloud):
        self.pools = {p.name: p for p in pools}
        self.cloud = cloud
        self._catalogs: dict = {}

    def pool_of(self, labels: dict):
        return self.pools.get(labels.get(wk.NODEPOOL_LABEL, ""))

    def instance_type(self, labels: dict) -> "InstanceType | None":
        pool = self.pool_of(labels)
        if pool is None:
            return None
        cat = self._catalogs.get(pool.name)
        if cat is None:
            cat = self._catalogs[pool.name] = {
                it.name: it
                for it in self.cloud.get_instance_types(pool)
            }
        return cat.get(labels.get(wk.INSTANCE_TYPE_LABEL, ""))

    def offering(self, labels: dict) -> "Offering | None":
        """The offering a node with these labels runs on, or None."""
        it = self.instance_type(labels)
        if it is None:
            return None
        zone = labels.get(wk.TOPOLOGY_ZONE_LABEL, "")
        ct = labels.get(wk.CAPACITY_TYPE_LABEL, wk.CAPACITY_TYPE_ON_DEMAND)
        for o in it.offerings:
            if o.zone == zone and o.capacity_type == ct:
                return o
        return None


@dataclass
class InterruptionNotice:
    """A spot interruption warning: the provider will reclaim the capacity
    behind ``provider_id`` at (about) ``deadline`` (clock seconds). The
    disruption controller marks the node and the ``InterruptionDrain``
    method replaces-then-drains it before the deadline
    (controllers/disruption/methods.py)."""

    provider_id: str
    deadline: float


class CloudProvider:
    """The SPI every provider implements (types.go:46-69)."""

    def create(self, node_claim):  # -> NodeClaim (with status filled)
        raise NotImplementedError

    def delete(self, node_claim) -> None:
        raise NotImplementedError

    def get(self, provider_id: str):  # -> NodeClaim
        raise NotImplementedError

    def list(self) -> list:  # -> [NodeClaim]
        raise NotImplementedError

    def get_instance_types(self, node_pool) -> list:  # -> [InstanceType]
        raise NotImplementedError

    def is_drifted(self, node_claim) -> str:
        """Returns a drift reason or '' (types.go IsDrifted)."""
        return ""

    def interruption_notices(self) -> list:
        """Pending :class:`InterruptionNotice`\\ s, drained on read (the
        SQS-queue analog of AWS's interruption handling). Providers
        without an interruption feed keep the empty default."""
        return []

    def name(self) -> str:
        raise NotImplementedError
