"""The truncation of a round's claims from one offering table
(``karpenter_tpu_torch/cloudprovider/offering_table.py``) against the plain
``truncate_instance_types`` of both packages.

Each seed builds one catalog twice, once in each package: types whose
offerings are of mixed availability (some types have none available), of
a few prices (so that names break ties), and of 1–3 requirement keys, one
of them custom. Its claims restrict the zone and the capacity type under
``In``, ``NotIn``, ``Exists`` and ``DoesNotExist``, name keys the offerings
lack, and ask minValues that the cut list meets or fails. Every claim's
list and error from the shared table equal, in order, the port's plain
truncation and the JAX package's, at λ = 0 and at λ > 0 over risky and
unknown-risk offerings.
"""

from __future__ import annotations

import importlib
import random

import pytest

from karpenter_tpu_torch.cloudprovider.offering_table import STATS, OfferingTable
from karpenter_tpu_torch.models.inflight import InFlightNodeClaim
from karpenter_tpu_torch.models.scheduler import SchedulerResults

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"
ZONES = ("zone-a", "zone-b", "zone-c")
CAPACITY = ("spot", "on-demand")
RACK = "example.com/rack"  # a custom offering key
TEAM = "example.com/team"  # a custom key no offering has
FAMILY = "example.com/family"
LAMBDAS = {"lam0": {}, "lam1.5": {"KARPENTER_SPOT_RISK_LAMBDA": "1.5",
                                  "KARPENTER_SPOT_RISK_DEFAULT": "0.3"}}


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _catalog_plan(rng: random.Random, n: int = 48) -> list:
    """Per type: (name, family, [(requirement triples, price, available,
    risk)]) as plain data, in an order that is not the names'."""
    names = [f"t{i:03d}" for i in range(n)]
    rng.shuffle(names)
    plan = []
    for name in names:
        offerings = []
        for _ in range(rng.randint(0, 5)):
            reqs = []
            if rng.random() < 0.85:
                reqs.append(("topology.kubernetes.io/zone", rng.choice(ZONES)))
            if rng.random() < 0.85:
                reqs.append(("karpenter.sh/capacity-type", rng.choice(CAPACITY)))
            if rng.random() < 0.3 or not reqs:
                reqs.append((RACK, rng.choice(("r1", "r2"))))
            offerings.append((reqs, rng.choice((0.25, 0.5, 0.75, 1.0, 1.5)),
                              rng.random() < 0.8,
                              rng.choice((None, 0.0, 0.2, 0.6))))
        plan.append((name, rng.choice(("m", "c", "r")), offerings))
    return plan


def _claim_plan(rng: random.Random, n_types: int) -> tuple:
    """(requirement specs, type positions, max_items) of one claim."""
    specs = []
    for key, values in (("topology.kubernetes.io/zone", ZONES),
                        ("karpenter.sh/capacity-type", CAPACITY)):
        op = rng.choice(("In", "NotIn", "Exists", "DoesNotExist", None))
        if op is not None:
            vals = rng.sample(values, rng.randint(1, len(values))) if op in ("In", "NotIn") else []
            specs.append((key, op, vals, None))
    if rng.random() < 0.4:
        specs.append((RACK, rng.choice(("In", "NotIn")), ["r1"], None))
    if rng.random() < 0.3:
        specs.append((TEAM, "In", ["blue"], None))
    if rng.random() < 0.3:
        # met by most cut lists at 2, failed by every one at 4
        specs.append((FAMILY, "Exists", [], rng.choice((2, 4))))
    positions = rng.sample(range(n_types), rng.randint(1, n_types))
    return specs, positions, rng.choice((5, 12, 60))


def _build(pkg, plan, claims):
    """The plan as ``pkg``'s objects: (types, [(types, Requirements, k)])."""
    sch, ty = mod(pkg, "scheduling"), mod(pkg, "cloudprovider.types")
    Req, Reqs = sch.Requirement, sch.Requirements
    its = []
    for name, family, offerings in plan:
        ofs = ty.Offerings(
            ty.Offering(Reqs(*[Req(k, "In", [v]) for k, v in reqs]), price, avail, risk)
            for reqs, price, avail, risk in offerings)
        its.append(ty.InstanceType(
            name, Reqs(Req("node.kubernetes.io/instance-type", "In", [name]),
                       Req(FAMILY, "In", [family])), ofs, {"cpu": 4.0}))
    out = [([its[p] for p in positions],
            Reqs(*[Req(k, op, vals, mv) for k, op, vals, mv in specs]), k)
           for specs, positions, k in claims]
    return its, out


def _plans(seed):
    rng = random.Random(seed)
    plan = _catalog_plan(rng)
    return plan, [_claim_plan(rng, len(plan)) for _ in range(24)]


def _names(answer):
    out, err = answer
    return [it.name for it in out], err


@pytest.mark.parametrize("lam", sorted(LAMBDAS))
@pytest.mark.parametrize("seed", range(8))
def test_table_equals_both_plain_truncations(seed, lam, monkeypatch):
    for k, v in LAMBDAS[lam].items():
        monkeypatch.setenv(k, v)
    plan, claims = _plans(seed)
    _, port_claims = _build(PORT, plan, claims)
    _, jax_claims = _build(JAX, plan, claims)
    port_plain = mod(PORT, "cloudprovider.types").truncate_instance_types
    jax_plain = mod(JAX, "cloudprovider.types").truncate_instance_types
    table = OfferingTable(it for its, _, _ in port_claims for it in its)
    errs = set()
    for (its, reqs, k), (jits, jreqs, _) in zip(port_claims, jax_claims):
        got = table.truncate(its, reqs, k)
        want = port_plain(its, reqs, k)
        # the same objects, in the same order, and the same error
        assert [id(it) for it in got[0]] == [id(it) for it in want[0]]
        assert got[1] == want[1]
        assert _names(got) == _names(jax_plain(jits, jreqs, k))
        errs.add(got[1] is None)
    assert errs == {True, False}  # minValues both met and failing


@pytest.mark.parametrize("lam", sorted(LAMBDAS))
def test_results_truncate_every_claim_from_one_table(lam, monkeypatch):
    """``SchedulerResults.truncate_instance_types`` over claims: each
    claim's types as the plain truncation leaves them, the full list kept
    where minValues fails."""
    for k, v in LAMBDAS[lam].items():
        monkeypatch.setenv(k, v)
    plain = mod(PORT, "cloudprovider.types").truncate_instance_types
    plan, claims = _plans(101)
    _, built = _build(PORT, plan, claims)
    new_claims, want = [], []
    for its, reqs, _ in built:
        claim = InFlightNodeClaim.__new__(InFlightNodeClaim)
        claim.instance_types, claim.requirements = list(its), reqs
        new_claims.append(claim)
        out, err = plain(its, reqs, 12)
        want.append([id(it) for it in (its if err else out)])
    SchedulerResults(new_claims, [], []).truncate_instance_types(12)
    assert [[id(it) for it in c.instance_types] for c in new_claims] == want


def test_types_of_one_price_are_ordered_by_name():
    ty, sch = mod(PORT, "cloudprovider.types"), mod(PORT, "scheduling")
    zone = sch.Requirements(sch.Requirement("topology.kubernetes.io/zone", "In", ["zone-a"]))
    its = [ty.InstanceType(n, sch.Requirements(), ty.Offerings([ty.Offering(
        sch.Requirements(*zone.values()), 1.0)]), {}) for n in ("c", "a", "d", "b")]
    its.append(ty.InstanceType("e", sch.Requirements(), ty.Offerings([ty.Offering(
        sch.Requirements(*zone.values()), 0.5, available=False)]), {}))
    out, err = OfferingTable(its).truncate(its, sch.Requirements(), 4)
    assert err is None and [it.name for it in out] == ["a", "b", "c", "d"]
    assert out == ty.truncate_instance_types(its, sch.Requirements(), 4)[0]


def test_memo_key_tells_apart_claims_that_differ_on_an_offering_key():
    """Two claims alike but for the zone, a key the offerings hold, are
    two keys of the memo and get their own orders; two claims alike but for
    a key no offering holds share every key."""
    ty, sch = mod(PORT, "cloudprovider.types"), mod(PORT, "scheduling")
    Req, Reqs = sch.Requirement, sch.Requirements
    zone = "topology.kubernetes.io/zone"
    its = [ty.InstanceType(n, Reqs(), ty.Offerings([
        ty.Offering(Reqs(Req(zone, "In", ["zone-a"])), pa),
        ty.Offering(Reqs(Req(zone, "In", ["zone-b"])), pb)]), {})
        for n, pa, pb in (("x", 1.0, 3.0), ("y", 2.0, 2.5), ("z", 3.0, 1.0))]
    in_a, in_b = Reqs(Req(zone, "In", ["zone-a"])), Reqs(Req(zone, "In", ["zone-b"]))
    in_b_team = Reqs(Req(zone, "In", ["zone-b"]), Req(TEAM, "In", ["blue"]))
    table = OfferingTable(its)
    before = dict(STATS)
    got_a = table.truncate(its, in_a, 3)
    got_b = table.truncate(its, in_b, 3)
    assert [it.name for it in got_a[0]] == ["x", "y", "z"]
    assert [it.name for it in got_b[0]] == ["z", "y", "x"]
    assert STATS["compat_evals"] - before["compat_evals"] == 4
    assert STATS["memo_hits"] - before["memo_hits"] == 0
    got_team = table.truncate(its, in_b_team, 3)
    assert got_team == got_b
    assert STATS["compat_evals"] - before["compat_evals"] == 4
    assert STATS["memo_hits"] - before["memo_hits"] == 2
    assert STATS["claims"] - before["claims"] == 3
    for reqs, got in ((in_a, got_a), (in_b, got_b), (in_b_team, got_team)):
        assert got == ty.truncate_instance_types(its, reqs, 3)
