"""Topology compiler: constraint groups → device group plan.

The port's copy of ``karpenter_tpu/ops/waves.py`` (imports changed);
host numpy, no device code.

TPU-native reformulation of the reference's TopologyGroup machinery
(topologygroup.go:167-274). The host engine resolves topology domain-by-
domain while pods stream through the FFD loop; the device path instead
compiles each constraint into static group structure the pack kernel
understands, so the whole batch stays one device call:

- zone topology spread (topologygroup.go nextDomainTopologySpread:167):
  a SELF-SELECTING owner placing identical pods one-at-a-time into the
  least-loaded allowed domain is exactly water-filling, so per-zone pod
  counts are computed in closed form and the group splits into zone-pinned
  SUBGROUPS. A NON-self-selecting owner never moves the counts it is
  checked against, so every pod lands in the same (sorted-first) min-count
  domain — one pinned subgroup.
- hostname topology spread (maxSkew s): every bin is its own hostname
  domain and an empty node is always mintable, so the domain-min is 0 and
  the kernel carries per-bin SPREAD-CLASS counts capped at s.
- hostname pod anti-affinity (nextDomainAntiAffinity:252) as CONFLICT
  CLASSES: a group DECLARING class c cannot share a bin with pods MATCHED
  by c and vice versa (the direct/inverse TopologyGroup pair,
  topology.go:225); bins carry declared/matched class bitmasks.
- hostname pod affinity (nextDomainAffinity:219) as AFFINITY CLASSES with
  per-bin MATCH COUNTS: a group owning class c may only land on bins whose
  matched count is already positive; when no matches exist anywhere a
  self-matching group bootstraps exactly ONE fresh bin (the host's
  bootstrap, topology.py:211). Cross-group chains (A follows B's labels)
  resolve inside the scan because counts evolve per step — the compiler
  orders followers after their targets, mirroring the host queue's
  requeue-to-back of pods that fail a round (queue.go:76).
- zone pod affinity: resolved at COMPILE time against the same sequential
  overlay the zone spreads use — allowed zones are the overlay's non-empty
  domains of the class selector; a unique zone pins the group, multiple
  matches become a zone IN-set (uncounted, exactly like the host's
  non-singleton Record), and a selector with no matches yet DEFERS the
  group to a later compile round (the host requeue).

The compiler runs a sequential OVERLAY simulation in FFD order: every
group's zone-pinned landings bump the compile-local domain counts of every
zone-keyed group whose selector matches it (ownership not required —
topologygroup.go:167 counts by selector), so later groups see earlier
groups' placements exactly as the host loop would. Groups whose affinity
targets haven't landed yet retry in later rounds until a fixed point; the
remainder routes to the host engine, which stays the semantic oracle.

Anything else — zone anti-affinity (the Schrödinger case records every
candidate domain), preferred terms, minDomains, same-selector spreads with
different parameters, hostname affinity onto pre-existing cluster matches —
routes to the host engine. Every host routing carries a REASON
(WavesPlan.host_reasons), exported as
karpenter_provisioning_host_routed_pods_total and surfaced per grid row by
the perf harness.

Vectorized-overlay contract
---------------------------

The default compiler (:class:`_VecCompiler`) and the sequential oracle
(:class:`_Compiler`) share ONE copy of the overlay scan: the scan consults
constraints only through predicate hooks (``_tg_selects`` /
``_zone_inverse_any`` / ``_cls_match`` / ``_cls_smatch`` / ``_cls_amatch``
/ ``_rec_tgs`` / ``_water``), and the vectorized compiler overrides those
hooks with batched numpy tables — groups dedup to distinct (namespace,
labels) signatures, match_labels-only selectors evaluate as one bitwise
subset test over an interned label-pair matrix, expression selectors fall
back to the exact Python matcher once per signature, ownership inverts the
registry's owner sets in one pass, and zone water-filling runs in closed
form over the [domains] axis (:func:`_water_fill_np`). Plans are therefore
bit-identical BY CONSTRUCTION, and tests/test_waves_parity.py enforces it
over 120+ seeded random mixes. KARPENTER_WAVES_SEQUENTIAL=1 (or
``compile_topology(..., vectorized=False)``) selects the oracle for A/B
debugging.

Downstream cache invalidation
-----------------------------

The tensorizer caches packed group rows keyed on (pod signature, this
plan's per-group extra requirements) inside the type-side cache entry
(ops/tensorize.py). Waves therefore participates in that contract through
the extra-req fingerprint alone: a group that lands in a different zone
subgroup (different pin/IN-set) keys a different row, while the OVERLAY
state itself (domain counts) never leaks into the cache — it only shapes
which extra reqs each subgroup carries.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.models.topology import (
    TYPE_AFFINITY,
    TYPE_ANTI_AFFINITY,
    TYPE_SPREAD,
    Topology,
)
from karpenter_tpu_torch.ops.tensorize import UNCAPPED
from karpenter_tpu_torch.scheduling import IN, Requirement, pod_requirements
from karpenter_tpu_torch.utils import resources as resutil

WORD = 32


@dataclass
class DeviceGroup:
    """One kernel scan row: identical pods + compiled topology structure."""

    pods: list
    extra_reqs: list = field(default_factory=list)  # e.g. zone pin
    bin_cap: int = UNCAPPED  # max pods of this group per bin
    single_bin: bool = False  # retained for direct kernel callers
    decl_classes: frozenset = frozenset()  # hostname-anti classes declared
    match_classes: frozenset = frozenset()  # hostname-anti classes matched
    spread_caps: dict = field(default_factory=dict)  # owned spread class -> maxSkew
    spread_matches: frozenset = frozenset()  # spread classes counting this group
    aff_need: frozenset = frozenset()  # hostname-affinity classes owned
    aff_match: frozenset = frozenset()  # hostname-affinity classes matching it


@dataclass
class WavesPlan:
    device_groups: list
    host_pods: list
    n_classes: int = 0
    n_spread_classes: int = 0
    n_aff_classes: int = 0
    # per-class TopologyGroup refs so the existing-node tensorizer can seed
    # per-node counts from the groups' domain maps (hostname-keyed)
    anti_tgs_by_class: list = field(default_factory=list)  # (direct, inverse|None)
    spread_tgs_by_class: list = field(default_factory=list)
    aff_tgs_by_class: list = field(default_factory=list)
    # why pods routed to the host engine: reason -> pod count, feeding the
    # karpenter_provisioning_host_routed_pods_total metric family
    host_reasons: dict = field(default_factory=dict)

    @property
    def device_pod_count(self):
        return sum(len(g.pods) for g in self.device_groups)

    def class_masks(self):
        """(g_decl [G,CW] u32, g_match [G,CW] u32) for the kernel."""
        G = len(self.device_groups)
        CW = max(1, (self.n_classes + WORD - 1) // WORD)
        decl = np.zeros((G, CW), dtype=np.uint32)
        match = np.zeros((G, CW), dtype=np.uint32)
        for g, dg in enumerate(self.device_groups):
            for c in dg.decl_classes:
                decl[g, c // WORD] |= np.uint32(1 << (c % WORD))
            for c in dg.match_classes:
                match[g, c // WORD] |= np.uint32(1 << (c % WORD))
        return decl, match

    def spread_tensors(self):
        """(g_sown [G,C] i32 cap where owned else UNCAPPED,
        g_smatch [G,C] bool) for the kernel's per-bin spread-class counts."""
        G = len(self.device_groups)
        C = max(1, self.n_spread_classes)
        sown = np.full((G, C), UNCAPPED, dtype=np.int32)
        smatch = np.zeros((G, C), dtype=bool)
        for g, dg in enumerate(self.device_groups):
            for c, cap in dg.spread_caps.items():
                sown[g, c] = cap
            for c in dg.spread_matches:
                smatch[g, c] = True
        return sown, smatch

    def aff_tensors(self):
        """(g_aneed [G,A] bool, g_amatch [G,A] bool) for the kernel's
        per-bin affinity-class match counts; bootstrap eligibility is
        derived in-kernel from amatch ∧ global-count==0."""
        G = len(self.device_groups)
        A = max(1, self.n_aff_classes)
        aneed = np.zeros((G, A), dtype=bool)
        amatch = np.zeros((G, A), dtype=bool)
        for g, dg in enumerate(self.device_groups):
            for c in dg.aff_need:
                aneed[g, c] = True
            for c in dg.aff_match:
                amatch[g, c] = True
        return aneed, amatch


def _group_key(g0):
    # FFD order (queue.go:37) with a most-constrained-first tie-break:
    # groups that will carry per-bin caps (required anti-affinity, hostname
    # spread) scan before unconstrained equals, so the bins their caps force
    # open are still fillable by the flexible groups behind them. Measured
    # on the anti+spread 5k config: 84 → 82 bins vs the host oracle's 81
    # (the host interleaves pod-at-a-time, which achieves the same effect).
    a = g0.affinity
    capped = bool(
        (a and a.pod_anti_affinity and a.pod_anti_affinity.required)
        or any(
            c.topology_key == wk.HOSTNAME_LABEL
            for c in g0.topology_spread_constraints
        )
    )
    req = g0.effective_requests()
    return (
        -req.get(resutil.CPU, 0.0),
        -req.get(resutil.MEMORY, 0.0),
        0 if capped else 1,
    )


def _water_fill(counts: dict, n: int) -> dict:
    """Distribute n additions over domains, always raising the lowest —
    the closed form of the host's least-loaded-domain placement loop.
    Returns domain -> additions. Deterministic (sorted domain tie-break)."""
    out = {d: 0 for d in counts}
    cur = dict(counts)
    remaining = n
    while remaining > 0:
        lo = min(cur.values())
        lows = sorted(d for d in cur if cur[d] == lo)
        higher = [v for v in cur.values() if v > lo]
        gap = (min(higher) - lo) if higher else None
        if gap is not None and gap * len(lows) <= remaining:
            for d in lows:
                cur[d] += gap
                out[d] += gap
            remaining -= gap * len(lows)
        else:
            per, extra = divmod(remaining, len(lows))
            for j, d in enumerate(lows):
                add = per + (1 if j < extra else 0)
                cur[d] += add
                out[d] += add
            remaining = 0
    return out


def _spread_conflicts(topology) -> set:
    """Hash keys of spread groups sharing (key, selector, namespaces) with
    another spread group but different parameters — their counts interact
    in ways the static plan cannot express."""
    seen: dict = {}
    conflicted: set = set()
    for hk, tg in topology.topologies.items():
        if tg.type != TYPE_SPREAD:
            continue
        sel = hk[3]  # selector component of hash_key
        ident = (tg.key, sel, tg.namespaces)
        other = seen.get(ident)
        if other is not None and other != hk:
            conflicted.add(hk)
            conflicted.add(other)
        seen[ident] = hk
    return conflicted


_HOST = "host"
_DEFER = "defer"


class _Compiler:
    """Sequential overlay compile of one batch (see module docstring)."""

    def __init__(self, groups, topology):
        self.groups = groups
        self.topology = topology
        self.reps = [g[0] for g in groups]
        self.own_by_gid = self._compute_owns()
        self.spread_conflicted = _spread_conflicts(topology)
        # inverse anti groups whose declarers are NOT in this batch and whose
        # key is not hostname constrain allowed domains invisibly → host
        self.zone_inverse = [
            tg for tg in topology.inverse_topologies.values()
            if tg.key != wk.HOSTNAME_LABEL
        ]
        # one class per distinct required hostname term owned in the batch
        self.anti_classes: dict = {}
        self.aff_classes: dict = {}
        self.spread_classes: dict = {}
        for own in self.own_by_gid:
            for tg in own:
                if tg.key != wk.HOSTNAME_LABEL:
                    continue
                if tg.type == TYPE_ANTI_AFFINITY:
                    self.anti_classes.setdefault(tg.hash_key(), len(self.anti_classes))
                elif tg.type == TYPE_SPREAD:
                    self.spread_classes.setdefault(
                        tg.hash_key(), len(self.spread_classes))
                elif tg.type == TYPE_AFFINITY:
                    self.aff_classes.setdefault(tg.hash_key(), len(self.aff_classes))
        T = topology.topologies
        self.anti_tgs = {hk: T[hk] for hk in self.anti_classes}
        self.spread_tgs = {hk: T[hk] for hk in self.spread_classes}
        self.aff_tgs = {hk: T[hk] for hk in self.aff_classes}
        # zone-keyed spread/affinity groups in registry order: the bump
        # targets (Topology.Record's singleton-domain commit mirror)
        self.zone_rec_tgs = [
            tg for tg in topology.topologies.values()
            if tg.key == wk.TOPOLOGY_ZONE_LABEL
            and tg.type in (TYPE_SPREAD, TYPE_AFFINITY)
        ]
        # compile-local domain counts for every ZONE-keyed spread/affinity
        # group; later groups see earlier groups' pinned landings exactly as
        # the host loop would
        self.overlay: dict = {}
        # in-batch matched-pod counts per hostname-affinity class (scan-order
        # viability; the kernel re-checks per bin at run time)
        self.aff_cnt = [0] * len(self.aff_classes)
        self.device_groups: list = []
        self.host_pods: list = []
        self.host_reasons: dict = {}
        self._pz_memo: dict = {}

    def _counts(self, tg) -> dict:
        c = self.overlay.get(id(tg))
        if c is None:
            c = self.overlay[id(tg)] = dict(tg.domains)
        return c

    def _route_host(self, pods, reason: str):
        self.host_pods.extend(pods)
        self.host_reasons[reason] = self.host_reasons.get(reason, 0) + len(pods)
        return _HOST

    def _compute_owns(self) -> list:
        """own_by_gid: every registry group owning gid's rep, in registry
        order (the scan handles constraints in registration order)."""
        return [
            [tg for tg in self.topology.topologies.values()
             if rep.uid in tg.owners]
            for rep in self.reps
        ]

    # ---- per-group predicates -------------------------------------------
    # The scan consults constraint predicates ONLY through these hooks, so
    # the sequential oracle and the vectorized compiler share one copy of
    # the overlay logic and can only differ in how predicates are evaluated.

    def _tg_selects(self, tg, gid) -> bool:
        return tg.selects(self.reps[gid])

    def _zone_inverse_any(self, gid) -> bool:
        rep = self.reps[gid]
        return any(tg.selects(rep) for tg in self.zone_inverse)

    def _cls_match(self, gid) -> frozenset:
        rep = self.reps[gid]
        return frozenset(
            c for hk, c in self.anti_classes.items()
            if self.anti_tgs[hk].selects(rep)
        )

    def _cls_smatch(self, gid) -> frozenset:
        rep = self.reps[gid]
        return frozenset(
            c for hk, c in self.spread_classes.items()
            if self.spread_tgs[hk].selects(rep)
        )

    def _cls_amatch(self, gid) -> frozenset:
        rep = self.reps[gid]
        return frozenset(
            c for hk, c in self.aff_classes.items()
            if self.aff_tgs[hk].selects(rep)
        )

    def _rec_tgs(self, gid) -> list:
        rep = self.reps[gid]
        return [tg for tg in self.zone_rec_tgs if tg.selects(rep)]

    def _pod_zone(self, gid):
        """pod's allowed-zone requirement, memoized per group (pure
        function of the rep's spec — semantically free in both modes)."""
        pz = self._pz_memo.get(gid)
        if pz is None:
            pz = self._pz_memo[gid] = pod_requirements(
                self.reps[gid]).get_req(wk.TOPOLOGY_ZONE_LABEL)
        return pz

    def _water(self, counts: dict, n: int) -> dict:
        return _water_fill(counts, n)

    def run(self) -> WavesPlan:
        pending = list(range(len(self.groups)))
        progress = True
        while progress and pending:
            progress = False
            still = []
            for gid in pending:
                outcome = self._compile_one(gid)
                if outcome is _DEFER:
                    still.append(gid)
                    continue
                progress = True
            pending = still
        for gid in pending:
            # affinity targets never materialized: the host queue fails these
            # the same way after its own retry cycle (queue.go:76 staleness)
            self._route_host(self.groups[gid], "affinity-unresolved")
        anti_by_class = [None] * len(self.anti_classes)
        for hk, c in self.anti_classes.items():
            anti_by_class[c] = (
                self.anti_tgs[hk], self.topology.inverse_topologies.get(hk))
        spread_by_class = [None] * len(self.spread_classes)
        for hk, c in self.spread_classes.items():
            spread_by_class[c] = self.spread_tgs[hk]
        aff_by_class = [None] * len(self.aff_classes)
        for hk, c in self.aff_classes.items():
            aff_by_class[c] = self.aff_tgs[hk]
        return WavesPlan(
            self.device_groups,
            self.host_pods,
            n_classes=len(self.anti_classes),
            n_spread_classes=len(self.spread_classes),
            n_aff_classes=len(self.aff_classes),
            anti_tgs_by_class=anti_by_class,
            spread_tgs_by_class=spread_by_class,
            aff_tgs_by_class=aff_by_class,
            host_reasons=dict(self.host_reasons),
        )

    def _compile_one(self, gid):
        pods = self.groups[gid]
        rep = self.reps[gid]
        own = self.own_by_gid[gid]

        if self._zone_inverse_any(gid):
            return self._route_host(pods, "zone-inverse-anti")

        extra_reqs: list = []
        bin_cap = UNCAPPED
        zone_split = None  # domain -> count (pinned landings)
        # set by ANY zone spread/affinity, pinned or not: composing two
        # zone constraints needs each other's answers → host engine
        zone_constrained = False
        decl: set = set()
        spread_caps: dict = {}
        aff_need: set = set()

        for tg in own:
            if tg.type == TYPE_SPREAD and tg.key == wk.TOPOLOGY_ZONE_LABEL:
                split = self._zone_spread(tg, gid, len(pods), zone_constrained)
                if split is None:
                    return self._route_host(pods, "zone-spread")
                zone_split, zone_constrained = split, True
            elif tg.type == TYPE_SPREAD and tg.key == wk.HOSTNAME_LABEL:
                cls = self.spread_classes[tg.hash_key()]
                cap = max(int(tg.max_skew), 1)
                spread_caps[cls] = min(spread_caps.get(cls, cap), cap)
            elif tg.type == TYPE_ANTI_AFFINITY and tg.key == wk.HOSTNAME_LABEL:
                decl.add(self.anti_classes[tg.hash_key()])
            elif tg.type == TYPE_AFFINITY and tg.key == wk.TOPOLOGY_ZONE_LABEL:
                res = self._zone_affinity(tg, gid, len(pods), zone_constrained)
                if res is _HOST:
                    return self._route_host(pods, "zone-affinity")
                if res is _DEFER:
                    return _DEFER
                req, pinned = res
                extra_reqs.append(req)
                zone_constrained = True
                if pinned is not None:
                    zone_split = {pinned: len(pods)}
            elif tg.type == TYPE_AFFINITY and tg.key == wk.HOSTNAME_LABEL:
                if any(tg.domains.values()):
                    # pre-existing cluster matches: the host engine's
                    # exact-domain bootstrap onto registered hostnames is
                    # not expressible as class counts
                    return self._route_host(pods, "hostname-affinity-existing")
                cls = self.aff_classes[tg.hash_key()]
                aff_need.add(cls)
                if not self._tg_selects(tg, gid) and self.aff_cnt[cls] == 0:
                    # target labels haven't landed yet: retry after the
                    # rest of the batch (the host requeue-to-back)
                    return _DEFER
            else:
                return self._route_host(pods, "unsupported-constraint")

        # classes whose selector matches this group (the inverse direction)
        match = self._cls_match(gid)
        if decl & match:
            # self-matching anti-affinity: at most one pod of the group per
            # bin, the classic one-replica-per-node shape
            bin_cap = 1
        # spread classes counting this group's pods (selector match,
        # topologygroup.go:167 — ownership not required; an owner whose own
        # labels don't match its selector contributes nothing, exactly like
        # the host count)
        smatch = self._cls_smatch(gid)
        amatch = self._cls_amatch(gid)

        self._emit(
            pods, extra_reqs, bin_cap, zone_split,
            frozenset(decl), match, dict(spread_caps),
            smatch, frozenset(aff_need), amatch,
        )
        self._bump_landings(gid, pods, zone_split)
        return "emit"

    # ---- per-constraint compile steps ----------------------------------
    def _zone_spread(self, tg, gid, n, zone_constrained):
        """domain -> count, or None for host."""
        if (
            tg.min_domains is not None
            or zone_constrained
            or tg.hash_key() in self.spread_conflicted
        ):
            return None
        counts = self._counts(tg)
        pod_zone = self._pod_zone(gid)
        allowed = {d: c for d, c in counts.items() if pod_zone.has(d)}
        if not allowed:
            return None
        if self._tg_selects(tg, gid):
            split = self._water(allowed, n)
            return {d: c for d, c in split.items() if c > 0}
        # non-self-selecting owner: counts never move, so every pod takes
        # the same min-count domain (sorted tie-break, topology.py:196);
        # maxSkew holds trivially at the minimum
        lo = min(allowed.values())
        d_star = sorted(d for d in allowed if allowed[d] == lo)[0]
        return {d_star: n}

    def _zone_affinity(self, tg, gid, n, zone_constrained):
        """(Requirement, pinned_zone|None) | _DEFER | _HOST."""
        if zone_constrained:
            return _HOST  # composed zone constraints: host engine
        counts = self._counts(tg)
        pod_zone = self._pod_zone(gid)
        nonzero = sorted(d for d, c in counts.items() if c > 0 and pod_zone.has(d))
        if nonzero:
            if len(nonzero) == 1:
                return (Requirement(wk.TOPOLOGY_ZONE_LABEL, IN, nonzero), nonzero[0])
            # several match domains: the pod may land in any (host records
            # nothing for non-singleton domains, topology.py:309)
            return (Requirement(wk.TOPOLOGY_ZONE_LABEL, IN, nonzero), None)
        if not self._tg_selects(tg, gid):
            return _DEFER
        # self-affinity bootstrap: deterministic sorted-first allowed domain
        # (the host engine's tie-break, topology.py:211-221)
        first = next((d for d in sorted(counts) if pod_zone.has(d)), None)
        if first is None:
            return _HOST  # no domain universe: host produces the error
        return (Requirement(wk.TOPOLOGY_ZONE_LABEL, IN, [first]), first)

    # ---- landings ------------------------------------------------------
    def _emit(self, pods, extra_reqs, bin_cap, zone_split, decl, match,
              spread_caps, smatch, aff_need, amatch):
        # batched subgroup construction: every field except the pod slice
        # and the zone pin is IDENTICAL across a wave's subgroups, so the
        # per-wave structure is built ONCE and shared — including
        # `spread_caps`, whose per-subgroup dict(…) copy used to dominate
        # this loop at fleet scale (ROADMAP named _emit as a residual host
        # stage that would dominate at 500k pods; a 100-zone wave now pays
        # one copy, not 100). Sharing is safe: DeviceGroup fields are
        # read-only after compile (tensorize/spread_tensors/class_masks
        # only read), and each call site already hands _emit a fresh dict.
        emit = self.device_groups.append
        if zone_split:
            # zone-pinned subgroups; pods partitioned in order
            cursor = 0
            zone = wk.TOPOLOGY_ZONE_LABEL
            for d in sorted(zone_split):
                cnt = zone_split[d]
                sub = pods[cursor: cursor + cnt]
                cursor += cnt
                emit(DeviceGroup(
                    sub, extra_reqs + [Requirement(zone, IN, [d])],
                    bin_cap, False, decl, match, spread_caps, smatch,
                    aff_need, amatch,
                ))
        else:
            emit(DeviceGroup(
                list(pods), extra_reqs, bin_cap, False, decl, match,
                spread_caps, smatch, aff_need, amatch,
            ))

    def _bump_landings(self, gid, pods, zone_split):
        """Commit this group's pinned landings into the overlay so later
        groups (and later compile rounds) see them — the compile-time
        mirror of Topology.Record's singleton-domain commit."""
        pinned = zone_split
        if pinned is None:
            # a plain node-selector zone pin also counts (the claim's zone
            # set is a singleton, so the host records it)
            pz = self._pod_zone(gid)
            if not pz.complement and len(pz.values) == 1:
                pinned = {next(iter(pz.values)): len(pods)}
        if pinned:
            for tg in self._rec_tgs(gid):
                counts = self._counts(tg)
                for d, c in pinned.items():
                    counts[d] = counts.get(d, 0) + c
        for cls in self._cls_amatch(gid):
            self.aff_cnt[cls] += len(pods)


def _col_sets(m: np.ndarray) -> list:
    """Per-column frozensets of the true rows of a [C, G] bool table —
    one nonzero pass instead of G flatnonzero calls."""
    C, G = m.shape
    out = [frozenset()] * G
    if m.size:
        gs, cs = np.nonzero(m.T)
        starts = np.searchsorted(gs, np.arange(G + 1))
        for g in range(G):
            lo, hi = int(starts[g]), int(starts[g + 1])
            if hi > lo:
                out[g] = frozenset(cs[lo:hi].tolist())
    return out


def _water_fill_np(counts: dict, n: int) -> dict:
    """Closed-form water fill over the [domains] axis — bit-identical to
    :func:`_water_fill` (the sequential oracle; the parity suite pins it):
    the final state raises every participating domain to a common level L*
    (the largest level affordable within n), then hands the remainder out
    one pod each to the first sorted-name domains at that level."""
    names = sorted(counts)
    c = np.array([counts[d] for d in names], dtype=np.int64)
    order = np.argsort(c, kind="stable")  # ascending counts, name tie-break
    cs = c[order]
    pre = np.concatenate([[0], np.cumsum(cs)])
    D = len(cs)
    # cost(k) = lift the k lowest to the (k+1)-th count; the last bracket
    # is unbounded. Find the bracket n lands in, then the level within it.
    ks = np.arange(1, D + 1)
    # the last bracket is unbounded: a level past every count + budget can
    # never be reached, so it serves as the +inf sentinel without overflow
    nxt = np.concatenate([cs[1:], [cs[-1] + n + 1]])
    cost_to_next = ks * nxt - pre[1:]  # cost to reach the NEXT count level
    k = int(np.searchsorted(cost_to_next, n, side="right"))
    k = min(k + 1, D)  # number of participating (lowest) domains
    level = (pre[k] + n) // k
    spent = level * k - pre[k]
    rem = int(n - spent)
    out = {d: 0 for d in names}
    lows = sorted(names[i] for i in order[:k])
    for i, d in enumerate(lows):
        add = int(level) - counts[d] + (1 if i < rem else 0)
        if add > 0:
            out[d] = add
    return out


class _VecCompiler(_Compiler):
    """The default compiler: the SAME sequential overlay scan as
    :class:`_Compiler` (one copy of the logic — the scan consults
    constraints only through the predicate hooks), with every predicate
    precomputed as batched numpy tables instead of per-group Python loops:

    - selector matching: groups dedup to distinct (namespace, labels)
      signatures; match_labels-only selectors evaluate as one bitwise
      subset test over an interned label-pair matrix [signatures × pairs],
      expression selectors fall back to the exact Python matcher once per
      signature; rows broadcast back to [classes × groups] by fancy index.
    - ownership: one inversion pass over the topology registry's owner
      sets replaces the per-group registry scan.
    - zone water-filling: the closed-form [domains]-axis fill
      (:func:`_water_fill_np`).

    Bit-identical plans to the sequential oracle by construction; the
    seeded parity suite (tests/test_waves_parity.py) enforces it."""

    def __init__(self, groups, topology):
        super().__init__(groups, topology)
        reps = self.reps
        G = len(reps)
        sig_of: dict = {}
        lab_ids = np.zeros(G, dtype=np.intp)
        distinct: list = []
        for g, rep in enumerate(reps):
            key = (rep.namespace, tuple(sorted(rep.metadata.labels.items())))
            i = sig_of.get(key)
            if i is None:
                i = sig_of[key] = len(distinct)
                distinct.append(rep)
            lab_ids[g] = i
        D = len(distinct)

        # the tgs whose per-group selection the scan consults, one row each
        anti_list = [None] * len(self.anti_classes)
        for hk, c in self.anti_classes.items():
            anti_list[c] = self.anti_tgs[hk]
        spread_list = [None] * len(self.spread_classes)
        for hk, c in self.spread_classes.items():
            spread_list[c] = self.spread_tgs[hk]
        aff_list = [None] * len(self.aff_classes)
        for hk, c in self.aff_classes.items():
            aff_list[c] = self.aff_tgs[hk]
        all_tgs: list = []
        row_of: dict = {}
        for tg in (*anti_list, *spread_list, *aff_list, *self.zone_inverse,
                   *self.zone_rec_tgs):
            if id(tg) not in row_of:
                row_of[id(tg)] = len(all_tgs)
                all_tgs.append(tg)

        # interned (key, value) pairs of every match_labels-only selector
        pair_idx: dict = {}
        for tg in all_tgs:
            sel = tg.selector
            if sel is not None and not sel.match_expressions:
                for kv in sel.match_labels.items():
                    pair_idx.setdefault(kv, len(pair_idx))
        enc = np.zeros((D, max(len(pair_idx), 1)), dtype=bool)
        for d, rep in enumerate(distinct):
            for kv in rep.metadata.labels.items():
                p = pair_idx.get(kv)
                if p is not None:
                    enc[d, p] = True

        # distinct namespaces intern too: the namespace gate evaluates per
        # (tg, namespace), not per (tg, signature)
        ns_names = []
        ns_pos: dict = {}
        ns_ids = np.zeros(D, dtype=np.intp)
        for d, rep in enumerate(distinct):
            i = ns_pos.get(rep.namespace)
            if i is None:
                i = ns_pos[rep.namespace] = len(ns_names)
                ns_names.append(rep.namespace)
            ns_ids[d] = i

        S = np.zeros((max(len(all_tgs), 1), D), dtype=bool)
        for i, tg in enumerate(all_tgs):
            sel = tg.selector
            if sel is None:
                continue  # selects() is False without a selector
            ns_row = np.array(
                [ns in tg.namespaces for ns in ns_names], dtype=bool
            )[ns_ids]
            if sel.match_expressions:
                # exact Python matcher, once per distinct signature
                row = np.array(
                    [sel.matches(rep.metadata.labels) for rep in distinct],
                    dtype=bool,
                )
            elif sel.match_labels:
                need = np.zeros(enc.shape[1], dtype=bool)
                for kv in sel.match_labels.items():
                    need[pair_idx[kv]] = True
                row = ~((need[None, :] & ~enc).any(axis=1))
            else:
                row = np.ones(D, dtype=bool)  # empty selector matches all
            S[i] = row & ns_row

        SG = S[:, lab_ids]
        self._row_of = row_of
        self._SG = SG

        def cls_rows(tg_list):
            if not tg_list:
                return np.zeros((0, G), dtype=bool)
            return SG[[row_of[id(tg)] for tg in tg_list]]

        anti_m = cls_rows(anti_list)
        spread_m = cls_rows(spread_list)
        aff_m = cls_rows(aff_list)
        zi = cls_rows(self.zone_inverse)
        self._zi_any = zi.any(axis=0) if zi.size else np.zeros(G, dtype=bool)
        # per-gid class sets / bump-target lists, one nonzero pass per table
        self._match_sets = _col_sets(anti_m)
        self._smatch_sets = _col_sets(spread_m)
        self._amatch_sets = _col_sets(aff_m)
        rec_m = cls_rows(self.zone_rec_tgs)
        self._rec_lists = [
            [self.zone_rec_tgs[i] for i in sorted(s)] for s in _col_sets(rec_m)
        ]

    def _compute_owns(self) -> list:
        """Registry-owner inversion: one pass over each group's owner set
        replaces the per-gid registry scan — same per-gid lists, in the
        same registry order (each tg appends once per owning gid)."""
        uid2gid = {rep.uid: g for g, rep in enumerate(self.reps)}
        own: list = [[] for _ in self.reps]
        for tg in self.topology.topologies.values():
            gids = {uid2gid[u] for u in tg.owners if u in uid2gid}
            for g in gids:
                own[g].append(tg)
        return own

    # -- predicate hooks over the precomputed tables ----------------------
    def _tg_selects(self, tg, gid) -> bool:
        row = self._row_of.get(id(tg))
        if row is None:  # not a scan-relevant tg; exact fallback
            return tg.selects(self.reps[gid])
        return bool(self._SG[row, gid])

    def _zone_inverse_any(self, gid) -> bool:
        return bool(self._zi_any[gid])

    def _cls_match(self, gid) -> frozenset:
        return self._match_sets[gid]

    def _cls_smatch(self, gid) -> frozenset:
        return self._smatch_sets[gid]

    def _cls_amatch(self, gid) -> frozenset:
        return self._amatch_sets[gid]

    def _rec_tgs(self, gid) -> list:
        return self._rec_lists[gid]

    def _water(self, counts: dict, n: int) -> dict:
        return _water_fill_np(counts, n)


def compile_topology(groups: list, topology, vectorized: bool | None = None) -> WavesPlan:
    """groups: list[list[Pod]] (identical pods per list, any order).
    Returns the device plan; pods whose constraints the device cannot
    express are returned in host_pods (with per-reason counts in
    host_reasons). ``vectorized=False`` (or KARPENTER_WAVES_SEQUENTIAL=1)
    compiles through the sequential oracle — same plan, per-group Python
    predicate evaluation; the parity suite diffs the two."""
    groups = sorted(groups, key=lambda g: _group_key(g[0]))  # FFD order

    if topology is None or not getattr(topology, "has_groups", False):
        return WavesPlan([DeviceGroup(list(g)) for g in groups], [])

    if vectorized is None:
        from karpenter_tpu_torch.utils.envknobs import env_str

        # inverse opt-in: setting the knob selects the SEQUENTIAL oracle
        vectorized = (env_str("KARPENTER_WAVES_SEQUENTIAL", "") or "") \
            .strip().lower() not in ("1", "true", "yes", "on")
    cls = _VecCompiler if vectorized else _Compiler
    # the sequential-oracle path is one of the slow edges the flight
    # recorder exists to attribute: the span's `vectorized` attr says
    # which compiler carried this round (karpenter_tpu_torch/obs)
    from karpenter_tpu_torch import obs

    with obs.span("waves.compile", groups=len(groups),
                  vectorized=bool(vectorized)):
        return cls(groups, topology).run()
