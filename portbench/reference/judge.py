"""The plain reference: Kubernetes scheduling semantics, judged claim by claim.

Plain Python and NumPy; it imports nothing of the program. It takes the
plain data the benchmark made (the configuration, its catalog from
``portbench/gen.py`` and a batch of plain pods), works out every type's
labels, allocatable and offerings again, and reads the program's answer
(claims with their pods, instance types and requirements, and the pods
reported unschedulable) only to judge it.

Each check counts the breaches of one guarantee that the configuration
states; a sound answer has none of any:

- ``unaccounted``: pods of the batch on no claim and not reported, pods
  placed twice or both placed and reported, and names not in the batch.
- ``bad_errors``: pods reported unschedulable that have no required pod
  affinity and that a claim of their own could take (in an empty cluster
  with unlimited NodePools only a pod's affinity can leave it unplaced).
- ``selector``: claims of an unknown NodePool, or whose requirements do
  not pin the NodePool label, or pin each node-selector label of each of
  their pods to that label's value.
- ``options``: claims whose instance types are not exactly those of their
  NodePool that are compatible with the claim's requirements, fit its
  pods in exact milli-cpu, bytes and pod slots, and have an offering
  compatible with its zone and capacity type; and claims no type can take.
- ``anti``: pairs of pods in one domain where either one's required pod
  anti-affinity selects the other.
- ``affinity``: pods with required pod affinity whose domain holds no other
  pod that the term selects, unless the pod selects itself (Kubernetes
  lets the first pod of a self-selecting group start it). A zone is held
  by pods on claims pinned to that one zone; a claim open to several
  zones must have a selected pod in each.
- ``spread``: per group of spread owners (key, selector, skew, node
  selector), counted from the plain labels as Kubernetes counts: owners of
  a zone (or other non-hostname) key on a claim not pinned to one domain,
  and domains holding more owners that match their own selector than the
  least count of matching pods over the eligible domains plus the skew
  (for a hostname key, a claim, the least count is 0). This bound holds
  whatever order the pods were admitted in (``_spread_breaches``).

``cost`` gives the hourly price of an answer: each claim at the cheapest
offering of its listed types that is compatible with its requirements,
as kwok launches it.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

# well-known labels (k8s.io/api/core/v1 well_known_labels.go; karpenter's
# pkg/apis/v1 labels.go) and the catalog's own (catalog.py)
HOSTNAME = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"
INSTANCE_TYPE = "node.kubernetes.io/instance-type"
CAPACITY_TYPE = "karpenter.sh/capacity-type"
NODEPOOL = "karpenter.sh/nodepool"
INSTANCE_CPU = "karpenter.tpu/instance-cpu"
INSTANCE_MEMORY = "karpenter.tpu/instance-memory"
INSTANCE_FAMILY = "karpenter.tpu/instance-family"
GIB = 2**30
MIB = 2**20

CHECKS = ("unaccounted", "bad_errors", "selector", "options", "anti",
          "affinity", "spread")


class Catalog:
    """The plain catalog worked out again: each type's labels, exact
    allocatable (milli-cpu and bytes rounded down, since requests are whole
    milli-cpu and bytes) and pod slots, offerings and price."""

    def __init__(self, cfg: dict, types: list):
        kr = cfg["catalog"]["kube_reserved"]
        self.types = types
        self.names = [t["name"] for t in types]
        self.index = {n: i for i, n in enumerate(self.names)}
        self.price = np.array([t["price"] for t in types])
        cpu_m, mem, slots = [], [], []
        for t in types:
            cpu = Fraction(str(t["cpu"]))
            mem_b = Fraction(str(t["mem_gib"])) * GIB
            if "cpu_max" in kr:
                # catalog.py make_instance_type: min(0.1, 1% of the cpu), 5%
                # of the memory
                r_cpu = min(Fraction(str(kr["cpu_max"])), cpu * Fraction(str(kr["cpu_share"])))
                r_mem = mem_b * Fraction(str(kr["memory_share"]))
            else:
                r_cpu, r_mem = Fraction(str(kr["cpu"])), kr["memory_mib"] * MIB
            cpu_m.append(int((cpu - r_cpu) * 1000))
            mem.append(int(mem_b - r_mem))
            slots.append(int(t["pods"]))
        self.alloc_cpu = np.array(cpu_m, dtype=np.int64)
        self.alloc_mem = np.array(mem, dtype=np.int64)
        self.slots = np.array(slots, dtype=np.int64)
        self.labels = [{
            INSTANCE_TYPE: {t["name"]}, ARCH: {t["arch"]}, OS: set(t["oses"]),
            ZONE: set(t["zones"]), CAPACITY_TYPE: set(t["capacity_types"]),
            **{k: {v} for k, v in t["labels"].items()},
        } for t in types]
        self.offerings = [[tuple(o) for o in t["offerings"]] for t in types]
        self.zones = sorted({z for t in types for z in t["zones"]})
        self._compat: dict = {}

    def domains(self, key: str) -> list:
        """Every value of ``key`` that some type offers."""
        return sorted({v for lab in self.labels for v in lab.get(key, ())})

    def compatible(self, reqs: dict) -> np.ndarray:
        """[T] bool: the type's labels meet every requirement on a key the
        type defines (keys it leaves undefined become node labels) and it
        has an offering whose zone and capacity type the requirements
        allow together."""
        key = tuple(sorted((k, c, tuple(v)) for k, (c, v) in reqs.items()))
        hit = self._compat.get(key)
        if hit is None:
            hit = self._compat[key] = np.array(
                [self._type_ok(lab, offs, reqs)
                 for lab, offs in zip(self.labels, self.offerings)])
        return hit

    @staticmethod
    def _type_ok(lab: dict, offerings: list, reqs: dict) -> bool:
        for k, (complement, values) in reqs.items():
            have = lab.get(k)
            if have is None:
                continue
            left = have - set(values) if complement else have & set(values)
            if not left:
                return False
        return any(_allowed(reqs, CAPACITY_TYPE, (ct,)) and _allowed(reqs, ZONE, (z,))
                   for ct, z in offerings)


def _allowed(reqs: dict, key: str, values) -> set:
    """The values of ``values`` that the requirement on ``key`` allows."""
    if key not in reqs:
        return set(values)
    complement, vals = reqs[key]
    return set(values) - set(vals) if complement else set(values) & set(vals)


def _selects(match: dict, labels: dict) -> bool:
    return all(labels.get(k) == v for k, v in match.items())


def _milli(cpu: float) -> int:
    return int(round(cpu * 1000))


def judge(cfg: dict, cat: Catalog, plain: list, answer: dict) -> dict:
    """{check: breaches} of the program's ``answer`` for the batch
    ``plain`` (see the module docstring)."""
    out = dict.fromkeys(CHECKS, 0)
    by_name = {p["name"]: p for p in plain}
    pools = {p["name"] for p in cfg["nodepools"]}
    claims = answer["claims"]

    # accounting
    seen: dict = {}
    for c in claims:
        for n in c["pods"]:
            seen[n] = seen.get(n, 0) + 1
    for n in answer["errors"]:
        seen[n] = seen.get(n, 0) + 1
    out["unaccounted"] = (sum(1 for n in by_name if n not in seen)
                          + sum(v - 1 for v in seen.values() if v > 1)
                          + sum(1 for n in seen if n not in by_name))

    # errors: only a pod's required affinity may leave it unplaced
    for n in answer["errors"]:
        p = by_name.get(n)
        if p is None or p["affinity"]:
            continue
        reqs = {k: [False, [v]] for k, v in p["selector"].items()}
        fits = ((cat.alloc_cpu >= _milli(p["cpu"])) & (cat.alloc_mem >= p["mem"])
                & (cat.slots >= 1))
        for pool in pools:
            if (cat.compatible({**reqs, NODEPOOL: [False, [pool]]}) & fits).any():
                out["bad_errors"] += 1
                break

    # each claim: its NodePool, its pods' selectors, its instance types
    zones_of = []
    for c in claims:
        reqs, pods = c["reqs"], [by_name[n] for n in c["pods"] if n in by_name]
        ok = (c["pool"] in pools and reqs.get(NODEPOOL) == [False, [c["pool"]]]
              and all(reqs.get(k) == [False, [v]]
                      for p in pods for k, v in p["selector"].items()))
        out["selector"] += not ok
        cpu = sum(_milli(p["cpu"]) for p in pods)
        mem = sum(p["mem"] for p in pods)
        fit = ((cat.alloc_cpu >= cpu) & (cat.alloc_mem >= mem)
               & (cat.slots >= len(pods)))
        want = cat.compatible(reqs) & fit
        listed = np.zeros(len(cat.names), dtype=bool)
        for name in c["options"]:
            i = cat.index.get(name)
            if i is None:
                listed = None
                break
            listed[i] = True
        out["options"] += (listed is None or not want.any()
                           or not np.array_equal(want, listed))
        zones_of.append(frozenset(_allowed(reqs, ZONE, cat.zones)))

    # the pods of each domain: a claim is its own hostname domain; a zone
    # holds the pods of claims pinned to that one zone
    placed = [(ci, by_name[n]) for ci, c in enumerate(claims)
              for n in c["pods"] if n in by_name]
    on_claim: dict = {}
    in_zone: dict = {}
    for ci, p in placed:
        on_claim.setdefault(ci, []).append(p)
        if len(zones_of[ci]) == 1:
            in_zone.setdefault(next(iter(zones_of[ci])), []).append(p)

    def near(ci, key):
        """Pods that share a domain of ``key`` with claim ``ci``."""
        if key == HOSTNAME:
            return on_claim.get(ci, [])
        return [q for cj, q in placed if zones_of[cj] & zones_of[ci]]

    for ci, p in placed:
        for term in p["anti"]:
            out["anti"] += sum(1 for q in near(ci, term["key"])
                               if q is not p and _selects(term["match"], q["labels"]))
        for term in p["affinity"]:
            if _selects(term["match"], p["labels"]):
                continue
            if term["key"] == HOSTNAME:
                held = [on_claim.get(ci, [])]
            else:
                held = [in_zone.get(z, []) for z in zones_of[ci]]
            out["affinity"] += not all(
                any(q is not p and _selects(term["match"], q["labels"])
                    for q in pods) for pods in held)

    # topology spread, per group of owners (the key, the selector, the
    # skew and the owners' node selector), counted from the plain labels
    groups: dict = {}
    for ci, p in placed:
        for s in p["spread"]:
            g = (s["key"], tuple(sorted(s["match"].items())), s["skew"],
                 tuple(sorted(p["selector"].items())))
            groups.setdefault(g, []).append((ci, p))
    for (key, match, skew, sel), owners in groups.items():
        out["spread"] += _spread_breaches(cat, claims, on_claim, key, dict(match),
                                          skew, dict(sel), owners)
    return out


def _pinned(reqs: dict, key: str, universe) -> str | None:
    """The one domain of ``key`` a claim's requirements allow, or None."""
    left = _allowed(reqs, key, universe)
    return next(iter(left)) if len(left) == 1 else None


def _spread_breaches(cat, claims, on_claim, key, match, skew, sel, owners) -> int:
    """Breaches of one spread group. Kubernetes admits an owner into
    domain d when count(d) + [the owner matches] - min over the eligible
    domains <= skew, count being the pods that match the selector; counts
    only grow within a batch. So for the last self-matching owner that
    entered d, count(d) + 1 held every self-matching owner now in d, and
    the min then was at most the min of the final counts: every domain
    must hold no more than min + skew self-matching owners, whatever the
    order of the pods. (An owner that does not match its own selector adds
    nothing, and pods that match it without owning it may have come after
    it, so no order-free bound counts them on the high side; on the low
    side they raise the min, which only loosens this bound.)

    A hostname domain is a claim, and a fresh node is always eligible, so
    the min is 0. Any other key's domain is the one value a claim's
    requirements allow: an owner on a claim open to several counts as a
    breach, since Kubernetes must know its domain to admit it; the
    eligible domains are those the catalog offers that the owners' node
    selector allows, and each counts the matching pods on the claims
    pinned to it."""
    if key == HOSTNAME:
        mine: dict = {}
        for ci, p in owners:
            if _selects(match, p["labels"]):
                mine[ci] = mine.get(ci, 0) + 1
        return sum(max(0, n - skew) for n in mine.values())
    universe = cat.domains(key)
    pinned = [_pinned(c["reqs"], key, universe) for c in claims]
    out = sum(1 for ci, _ in owners if pinned[ci] is None)
    eligible = _allowed({key: [False, [sel[key]]]} if key in sel else {}, key, universe)
    count = dict.fromkeys(eligible, 0)
    for ci, pods in on_claim.items():
        if pinned[ci] in count:
            count[pinned[ci]] += sum(1 for q in pods if _selects(match, q["labels"]))
    lo = min(count.values()) if count else 0
    mine = {}
    for ci, p in owners:
        if pinned[ci] is not None and _selects(match, p["labels"]):
            mine[pinned[ci]] = mine.get(pinned[ci], 0) + 1
    return out + sum(max(0, n - lo - skew) for n in mine.values())


def cost(cat: Catalog, answer: dict) -> float:
    """The answer's hourly price: each claim at its cheapest listed type
    with an offering compatible with its requirements."""
    total = 0.0
    for c in answer["claims"]:
        ok = cat.compatible(c["reqs"])
        prices = [cat.price[i] for i in (cat.index.get(n) for n in c["options"])
                  if i is not None and ok[i]]
        total += min(prices) if prices else float("inf")
    return total


def placed(answer: dict) -> int:
    return sum(len(c["pods"]) for c in answer["claims"])
