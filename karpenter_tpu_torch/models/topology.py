"""Topology constraint engine: spread, pod affinity, pod anti-affinity.

The port's copy of ``karpenter_tpu/models/topology.py`` (imports changed).

Behavioral mirror of the reference's pkg/controllers/provisioning/scheduling/
{topology.go:43-309, topologygroup.go:56-274, topologynodefilter.go}:

- `TopologyGroup` tracks per-(key,type,selector) domain→count maps, hashed
  and deduplicated so one group serves N owner pods (topologygroup.go Hash).
- Anti-affinity is tracked BOTH ways: `inverse` groups follow pods that
  declare anti-affinity so that pods they select can be kept away
  (topology.go:49-53).
- `next domain` math mirrors kube-scheduler: spread picks the least-loaded
  allowed domain within maxSkew (topologygroup.go:167-217), affinity requires
  a non-empty domain (:219), anti-affinity an empty one (:252).

The device path (ops/waves.py) compiles the self-selecting common cases of
these groups into per-zone sub-groups / per-bin caps; everything else runs
through this host engine.

A ``Topology`` is built inside the port's ``topology.build`` span, and
each count of a group's domains from the cluster view
(``_count_domains``, ``_update_inverse_affinities``) inside a
``topology.count`` span whose ``pods`` attribute is the running pods the
count scanned; the JAX package opens neither.
"""

from __future__ import annotations

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.scheduling import (
    DOES_NOT_EXIST,
    IN,
    Requirement,
    Requirements,
    label_requirements,
    node_selector_requirements,
)

TYPE_SPREAD = "topology spread"
TYPE_AFFINITY = "pod affinity"
TYPE_ANTI_AFFINITY = "pod anti-affinity"

_MAX = 1 << 31


def has_pod_anti_affinity(pod) -> bool:
    return bool(
        pod.affinity
        and pod.affinity.pod_anti_affinity
        and (pod.affinity.pod_anti_affinity.required or pod.affinity.pod_anti_affinity.preferred)
    )


def ignored_for_topology(pod) -> bool:
    """topology.go IgnoredForTopology:437 — unscheduled/terminal/terminating
    pods don't count."""
    return not pod.node_name or pod.phase in ("Succeeded", "Failed") or pod.terminating


class TopologyNodeFilter:
    """OR of requirement sets a node must match to count for a spread group
    (topologynodefilter.go)."""

    def __init__(self, terms):
        self.terms = terms  # [Requirements]; empty = always matches

    @classmethod
    def for_pod(cls, pod):
        selector_reqs = label_requirements(pod.node_selector)
        na = pod.affinity.node_affinity if pod.affinity else None
        if na is None or not na.required:
            return cls([selector_reqs])
        terms = []
        for term in na.required:
            reqs = Requirements()
            reqs.add(*selector_reqs.values())
            reqs.add(*node_selector_requirements(term.match_expressions).values())
            terms.append(reqs)
        return cls(terms)

    @classmethod
    def always(cls):
        return cls([])

    def matches_labels(self, labels: dict) -> bool:
        return self.matches_requirements(label_requirements(labels))

    def matches_requirements(self, reqs: Requirements) -> bool:
        if not self.terms:
            return True
        return any(
            reqs.compatible(t, allow_undefined=wk.WELL_KNOWN_LABELS) is None for t in self.terms
        )

    def hash_key(self):
        return tuple(
            tuple(sorted((r.key, r.complement, tuple(sorted(r.values))) for r in t.values()))
            for t in self.terms
        )


class TopologyGroup:
    def __init__(
        self,
        group_type: str,
        key: str,
        pod,
        namespaces: frozenset,
        selector,  # LabelSelector | None
        max_skew: int,
        min_domains: int | None,
        domains,  # iterable of known domain names
    ):
        self.type = group_type
        self.key = key
        self.namespaces = frozenset(namespaces)
        self.selector = selector
        self.max_skew = max_skew
        self.min_domains = min_domains
        self.node_filter = (
            TopologyNodeFilter.for_pod(pod) if group_type == TYPE_SPREAD else TopologyNodeFilter.always()
        )
        self.domains = {d: 0 for d in domains or ()}
        self.empty_domains = set(domains or ())
        self.owners: set = set()

    # --- identity -------------------------------------------------------
    def hash_key(self):
        sel = None
        if self.selector is not None:
            sel = (
                tuple(sorted(self.selector.match_labels.items())),
                tuple(
                    (e.key, e.operator, tuple(sorted(e.values)))
                    for e in self.selector.match_expressions
                ),
            )
        return (
            self.type,
            self.key,
            self.namespaces,
            sel,
            self.max_skew,
            self.node_filter.hash_key(),
        )

    # --- counting -------------------------------------------------------
    def record(self, *domains):
        for d in domains:
            self.domains[d] = self.domains.get(d, 0) + 1
            self.empty_domains.discard(d)

    def record_n(self, domain, n: int):
        """record() with multiplicity — the device decoder commits a whole
        group of identical pods at once."""
        self.domains[domain] = self.domains.get(domain, 0) + n
        self.empty_domains.discard(domain)

    def register(self, *domains):
        for d in domains:
            if d not in self.domains:
                self.domains[d] = 0
                self.empty_domains.add(d)

    def selects(self, pod) -> bool:
        if pod.namespace not in self.namespaces:
            return False
        if self.selector is None:
            return False
        return self.selector.matches(pod.metadata.labels)

    def counts(self, pod, requirements: Requirements) -> bool:
        return self.selects(pod) and self.node_filter.matches_requirements(requirements)

    # --- next-domain math ----------------------------------------------
    def get(self, pod, pod_domains: Requirement, node_domains: Requirement) -> Requirement:
        if self.type == TYPE_SPREAD:
            return self._next_spread(pod, pod_domains, node_domains)
        if self.type == TYPE_AFFINITY:
            return self._next_affinity(pod, pod_domains, node_domains)
        return self._next_anti_affinity(pod_domains)

    def _domain_min_count(self, pod_domains: Requirement) -> int:
        # hostname topologies can always mint a fresh (empty) node
        if self.key == wk.HOSTNAME_LABEL:
            return 0
        lo = _MAX
        supported = 0
        for domain, count in self.domains.items():
            if pod_domains.has(domain):
                supported += 1
                lo = min(lo, count)
        if self.min_domains is not None and supported < self.min_domains:
            lo = 0
        return lo

    def _next_spread(self, pod, pod_domains, node_domains) -> Requirement:
        lo = self._domain_min_count(pod_domains)
        self_selecting = self.selects(pod)
        best, best_count = None, _MAX
        # deterministic tie-break by domain name (the reference picks an
        # arbitrary min-count domain; determinism aids reproducibility)
        for domain in sorted(self.domains):
            if not node_domains.has(domain):
                continue
            count = self.domains[domain]
            if self_selecting:
                count += 1
            if count - lo <= self.max_skew and count < best_count:
                best, best_count = domain, count
        if best is None:
            return Requirement(self.key, DOES_NOT_EXIST)
        return Requirement(self.key, IN, [best])

    def _next_affinity(self, pod, pod_domains, node_domains) -> Requirement:
        options = [d for d in self.domains if pod_domains.has(d) and self.domains[d] > 0]
        if not options and self.selects(pod):
            # self-affinity bootstrap: prefer a domain the node already allows
            intersected = pod_domains.intersection(node_domains)
            for domain in sorted(self.domains):
                if intersected.has(domain):
                    options.append(domain)
                    break
            if not options:
                for domain in sorted(self.domains):
                    if pod_domains.has(domain):
                        options.append(domain)
                        break
        if not options:
            return Requirement(self.key, DOES_NOT_EXIST)
        return Requirement(self.key, IN, options)

    def _next_anti_affinity(self, pod_domains) -> Requirement:
        options = [
            d for d in self.empty_domains if pod_domains.has(d) and self.domains.get(d, 0) == 0
        ]
        if not options:
            return Requirement(self.key, DOES_NOT_EXIST)
        return Requirement(self.key, IN, options)


class Topology:
    """Hash-deduped topology group registry + the AddRequirements/Record
    protocol the scheduler drives (topology.go:43)."""

    def __init__(self, cluster=None, domains: dict | None = None, pods=()):
        with obs.span("topology.build"):
            self.cluster = cluster  # optional ClusterView (state plane)
            self.domains = {k: set(v) for k, v in (domains or {}).items()}
            self.topologies: dict = {}
            self.inverse_topologies: dict = {}
            self.excluded_pods = {p.uid for p in pods}
            # (namespace, labels) -> [tg...] whose selector matches; selects()
            # is a pure function of those two, so pods sharing a label
            # signature share one registry scan (the record path is
            # per-(pod, tg) otherwise — the dominant cost of committing a
            # device solve). update() invalidates (it can add groups).
            self._sel_memo: dict = {}
            # uid -> [tg...] the pod currently owns: update() un-registers via
            # this index instead of sweeping every registry group per pod
            self._owner_tgs: dict = {}
            if cluster is not None:
                self._update_inverse_affinities()
            for p in pods:
                self.update(p)

    # -- lifecycle -------------------------------------------------------
    def update(self, pod):
        """(Re)register pod as owner of its topologies; called initially and
        after each relaxation (topology.go Update:105)."""
        self._sel_memo.clear()  # may add groups below
        for tg in self._owner_tgs.pop(pod.uid, ()):
            tg.owners.discard(pod.uid)

        if has_pod_anti_affinity(pod):
            self._update_inverse_anti_affinity(pod, None)

        owned = []
        for tg in self._new_for_topologies(pod) + self._new_for_affinities(pod):
            key = tg.hash_key()
            existing = self.topologies.get(key)
            if existing is None:
                self._count_domains(tg)
                self.topologies[key] = tg
                existing = tg
            existing.owners.add(pod.uid)
            owned.append(existing)
        if owned:
            self._owner_tgs[pod.uid] = owned
        return None

    def register(self, topology_key: str, domain: str):
        for tg in self.topologies.values():
            if tg.key == topology_key:
                tg.register(domain)
        for tg in self.inverse_topologies.values():
            if tg.key == topology_key:
                tg.register(domain)

    # -- scheduler protocol ---------------------------------------------
    def add_requirements(self, pod_requirements, node_requirements, pod, allow_undefined=None):
        """Tighten node requirements with the next allowed domain per
        matching group (topology.go AddRequirements:168). Returns
        (Requirements, error)."""
        requirements = Requirements()
        requirements.add(*node_requirements.values())
        for tg in self._matching_topologies(pod, node_requirements):
            pod_domains = pod_requirements.get_req(tg.key)
            node_domains = node_requirements.get_req(tg.key)
            domains = tg.get(pod, pod_domains, node_domains)
            if len(domains) == 0:
                return None, (
                    f"unsatisfiable topology constraint for {tg.type}, key={tg.key}"
                )
            requirements.add(domains)
        return requirements, None

    def record(self, pod, requirements: Requirements, allow_undefined=None):
        """Commit domain usage after a pod lands (topology.go Record:141)."""
        self.record_many(pod, requirements, 1)

    def _selecting(self, pod) -> list:
        """Registry groups whose selector matches this pod, memoized by
        (namespace, labels) — the pure inputs of TopologyGroup.selects."""
        key = (pod.namespace, tuple(sorted(pod.metadata.labels.items())))
        sel = self._sel_memo.get(key)
        if sel is None:
            sel = self._sel_memo[key] = [
                tg for tg in self.topologies.values() if tg.selects(pod)
            ]
        return sel

    def record_many(self, pod, requirements: Requirements, n: int):
        """record() with multiplicity: the device decoder lands a group of
        n identical pods in one commit; `pod` is the group representative."""
        for tg in self._selecting(pod):
            if tg.node_filter.matches_requirements(requirements):
                domains = requirements.get_req(tg.key)
                if tg.type == TYPE_ANTI_AFFINITY:
                    for v in domains.values:
                        tg.record_n(v, n)
                elif len(domains) == 1:
                    tg.record_n(next(iter(domains.values)), n)
        for tg in self.inverse_topologies.values():
            if pod.uid in tg.owners:
                for v in requirements.get_req(tg.key).values:
                    tg.record_n(v, n)

    # -- construction helpers -------------------------------------------
    def _new_for_topologies(self, pod):
        out = []
        for cs in pod.topology_spread_constraints:
            out.append(
                TopologyGroup(
                    TYPE_SPREAD,
                    cs.topology_key,
                    pod,
                    frozenset({pod.namespace}),
                    cs.label_selector,
                    cs.max_skew,
                    cs.min_domains,
                    self.domains.get(cs.topology_key, ()),
                )
            )
        return out

    def _new_for_affinities(self, pod):
        out = []
        aff = pod.affinity
        if aff is None:
            return out
        for group_type, pa in ((TYPE_AFFINITY, aff.pod_affinity), (TYPE_ANTI_AFFINITY, aff.pod_anti_affinity)):
            if pa is None:
                continue
            terms = list(pa.required) + [w.pod_affinity_term for w in pa.preferred]
            for term in terms:
                out.append(
                    TopologyGroup(
                        group_type,
                        term.topology_key,
                        pod,
                        self._namespaces(pod.namespace, term),
                        term.label_selector,
                        _MAX,
                        None,
                        self.domains.get(term.topology_key, ()),
                    )
                )
        return out

    def _namespaces(self, pod_namespace, term) -> frozenset:
        if not term.namespaces and term.namespace_selector is None:
            return frozenset({pod_namespace})
        out = set(term.namespaces)
        if term.namespace_selector is not None and self.cluster is not None:
            out.update(self.cluster.namespaces_matching(term.namespace_selector))
        return frozenset(out)

    def _update_inverse_affinities(self):
        scanned = 0
        with obs.span("topology.count") as sp:
            for pod, node_labels in self.cluster.pods_with_anti_affinity():
                scanned += 1
                if pod.uid in self.excluded_pods:
                    continue
                self._update_inverse_anti_affinity(pod, node_labels)
            if sp is not None:
                sp.attrs = dict(pods=scanned)

    def _update_inverse_anti_affinity(self, pod, node_labels):
        """Track domains occupied by pods DECLARING anti-affinity so pods
        they select avoid them (topology.go:225). Preferences intentionally
        untracked."""
        for term in pod.affinity.pod_anti_affinity.required:
            tg = TopologyGroup(
                TYPE_ANTI_AFFINITY,
                term.topology_key,
                pod,
                self._namespaces(pod.namespace, term),
                term.label_selector,
                _MAX,
                None,
                self.domains.get(term.topology_key, ()),
            )
            key = tg.hash_key()
            existing = self.inverse_topologies.get(key)
            if existing is None:
                self.inverse_topologies[key] = tg
                existing = tg
            if node_labels and tg.key in node_labels:
                existing.record(node_labels[tg.key])
            existing.owners.add(pod.uid)

    def _count_domains(self, tg: TopologyGroup):
        """Seed group counts from existing cluster pods
        (topology.go countDomains:256)."""
        if self.cluster is None:
            return
        scanned = 0
        with obs.span("topology.count") as sp:
            for pod, node_labels in self.cluster.pods_matching(tg.namespaces, tg.selector):
                scanned += 1
                if ignored_for_topology(pod) or pod.uid in self.excluded_pods:
                    continue
                domain = (node_labels or {}).get(tg.key)
                if domain is None and tg.key == wk.HOSTNAME_LABEL:
                    domain = pod.node_name
                if domain is None:
                    continue
                if not tg.node_filter.matches_labels(node_labels or {}):
                    continue
                tg.record(domain)
            if sp is not None:
                sp.attrs = dict(pods=scanned)

    def _matching_topologies(self, pod, requirements):
        out = [tg for tg in self.topologies.values() if pod.uid in tg.owners]
        out += [tg for tg in self.inverse_topologies.values() if tg.counts(pod, requirements)]
        return out

    @property
    def has_groups(self) -> bool:
        return bool(self.topologies or self.inverse_topologies)
