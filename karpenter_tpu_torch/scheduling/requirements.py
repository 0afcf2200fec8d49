"""Label-requirement set algebra.

Behavioral mirror of the reference's pkg/scheduling/requirement.go:33-188 and
requirements.go:36-253: a Requirement is a value set with an optional
complement flag (NotIn/Exists are complements), integer bounds for Gt/Lt, and
a minValues flexibility floor; Requirements is a key-indexed conjunction with
one-way `compatible` (undefined custom labels deny, undefined well-known
labels allow) and two-way `intersects`.

This algebra is also the host-side reference semantics for the device
tensorization (ops/tensorize.py) which lowers concrete (non-complement)
requirements to bitmasks over interned value vocabularies.
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, sort_terms_by_weight

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"

_INF = 1 << 62  # stands in for "all possible values" when complemented


def _within(value: str, gt: int | None, lt: int | None) -> bool:
    if gt is None and lt is None:
        return True
    try:
        v = int(value)
    except (TypeError, ValueError):
        return False
    if gt is not None and v <= gt:
        return False
    if lt is not None and v >= lt:
        return False
    return True


class Requirement:
    """One label-key constraint (requirement.go:33)."""

    __slots__ = ("key", "complement", "values", "greater_than", "less_than", "min_values")

    def __init__(self, key: str, operator: str, values=(), min_values: int | None = None):
        key = wk.normalize(key)
        self.key = key
        self.min_values = min_values
        self.greater_than: int | None = None
        self.less_than: int | None = None
        if operator == IN:
            self.complement = False
            self.values = frozenset(values)
        elif operator == DOES_NOT_EXIST:
            self.complement = False
            self.values = frozenset()
        else:
            self.complement = True
            self.values = frozenset(values) if operator == NOT_IN else frozenset()
            if operator == GT:
                self.greater_than = int(next(iter(values)))
            elif operator == LT:
                self.less_than = int(next(iter(values)))

    @classmethod
    def _raw(cls, key, complement, values, gt=None, lt=None, min_values=None) -> "Requirement":
        r = cls.__new__(cls)
        r.key = key
        r.complement = complement
        r.values = frozenset(values)
        r.greater_than = gt
        r.less_than = lt
        r.min_values = min_values
        return r

    @property
    def operator(self) -> str:
        if self.complement:
            return NOT_IN if self.values else EXISTS  # Gt/Lt report Exists-with-bounds
        return IN if self.values else DOES_NOT_EXIST

    def intersection(self, other: "Requirement") -> "Requirement":
        """requirement.go Intersection semantics, including bound collapse."""
        complement = self.complement and other.complement
        gt = _max_opt(self.greater_than, other.greater_than)
        lt = _min_opt(self.less_than, other.less_than)
        mv = _max_opt(self.min_values, other.min_values)
        if gt is not None and lt is not None and gt >= lt:
            return Requirement._raw(self.key, False, (), min_values=mv)
        if self.complement and other.complement:
            values = self.values | other.values
        elif self.complement:
            values = other.values - self.values
        elif other.complement:
            values = self.values - other.values
        else:
            values = self.values & other.values
        values = frozenset(v for v in values if _within(v, gt, lt))
        if not complement:
            gt, lt = None, None
        return Requirement._raw(self.key, complement, values, gt, lt, mv)

    def has(self, value: str) -> bool:
        if self.complement:
            return value not in self.values and _within(value, self.greater_than, self.less_than)
        return value in self.values and _within(value, self.greater_than, self.less_than)

    def __len__(self) -> int:
        if self.complement:
            return _INF - len(self.values)
        return len(self.values)

    def any(self) -> str:
        """A representative allowed value (requirement.go Any).

        Deviation from the reference: for unbounded complement requirements
        (NotIn/Exists with no Gt/Lt) the reference fabricates a random
        integer; we return "" so Labels() never stamps fabricated values.
        Bounded requirements still yield a valid in-range value.
        """
        if not self.complement and self.values:
            return sorted(self.values)[0]
        if self.complement and (self.greater_than is not None or self.less_than is not None):
            lo = (self.greater_than + 1) if self.greater_than is not None else 0
            hi = self.less_than if self.less_than is not None else lo + 1_000_000
            for cand in range(lo, hi):
                if str(cand) not in self.values:
                    return str(cand)
        return ""

    def values_list(self) -> list:
        return sorted(self.values)

    def to_node_selector_requirement(self) -> NodeSelectorRequirement:
        """Emit the API form (requirement.go NodeSelectorRequirement:90)."""
        if self.greater_than is not None:
            return NodeSelectorRequirement(self.key, GT, [str(self.greater_than)], self.min_values)
        if self.less_than is not None:
            return NodeSelectorRequirement(self.key, LT, [str(self.less_than)], self.min_values)
        return NodeSelectorRequirement(self.key, self.operator, sorted(self.values), self.min_values)

    def __repr__(self) -> str:
        op = self.operator
        s = f"{self.key} {op}"
        if self.values:
            vals = sorted(self.values)
            if len(vals) > 5:
                vals = vals[:5] + [f"and {len(self.values) - 5} others"]
            s += f" {vals}"
        if self.greater_than is not None:
            s += f" >{self.greater_than}"
        if self.less_than is not None:
            s += f" <{self.less_than}"
        return s

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Requirement)
            and self.key == other.key
            and self.complement == other.complement
            and self.values == other.values
            and self.greater_than == other.greater_than
            and self.less_than == other.less_than
            and self.min_values == other.min_values
        )

    def __hash__(self):
        return hash((self.key, self.complement, self.values, self.greater_than, self.less_than, self.min_values))


def _max_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def _min_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


class Requirements(dict):
    """Key → Requirement conjunction (requirements.go:36)."""

    def __init__(self, *reqs):
        super().__init__()
        self.add(*reqs)

    def add(self, *reqs: Requirement):
        for r in reqs:
            existing = super().get(r.key)
            if existing is not None:
                r = r.intersection(existing)
            self[r.key] = r

    def copy(self) -> "Requirements":
        out = Requirements()
        dict.update(out, self)
        return out

    def get_req(self, key: str) -> Requirement:
        r = super().get(key)
        if r is None:
            return Requirement(key, EXISTS)  # undefined keys allow any value
        return r

    def has_key(self, key: str) -> bool:
        return key in self

    def merged_with(self, other: "Requirements") -> "Requirements":
        out = self.copy()
        out.add(*other.values())
        return out

    def compatible(self, incoming: "Requirements", allow_undefined=None) -> str | None:
        """One-way compatibility (requirements.go Compatible :174-187).

        Returns None when compatible, else an error string. Custom labels in
        `incoming` that we don't define are denied (unless operator NotIn /
        DoesNotExist); labels in `allow_undefined` (typically the well-known
        set) are allowed to be undefined.
        """
        allow = allow_undefined if allow_undefined is not None else frozenset()
        errs = []
        for key in incoming:
            if key in allow:
                continue
            op = incoming.get_req(key).operator
            if key in self or op in (NOT_IN, DOES_NOT_EXIST):
                continue
            errs.append(f'label "{key}" does not have known values')
        err = self.intersects(incoming)
        if err:
            errs.append(err)
        return "; ".join(errs) if errs else None

    def is_compatible(self, incoming: "Requirements", allow_undefined=None) -> bool:
        return self.compatible(incoming, allow_undefined) is None

    def intersects(self, incoming: "Requirements") -> str | None:
        """Two-way overlap over shared keys (requirements.go Intersects :282).

        Empty intersection is tolerated iff BOTH sides are NotIn/DoesNotExist.
        """
        errs = []
        small, large = (self, incoming) if len(self) <= len(incoming) else (incoming, self)
        for key in small:
            if key not in large:
                continue
            existing = self.get_req(key)
            inc = incoming.get_req(key)
            if len(existing.intersection(inc)) == 0:
                if inc.operator in (NOT_IN, DOES_NOT_EXIST) and existing.operator in (NOT_IN, DOES_NOT_EXIST):
                    continue
                errs.append(f"key {key}, {inc!r} not in {existing!r}")
        return "; ".join(errs) if errs else None

    def labels(self) -> dict:
        """Concrete labels derivable from the requirements (requirements.go
        Labels), excluding restricted node labels."""
        out = {}
        for key, r in self.items():
            if wk.is_restricted_node_label(key):
                continue
            v = r.any()
            if v:
                out[key] = v
        return out

    def keys_set(self) -> frozenset:
        return frozenset(self.keys())

    def has_min_values(self) -> bool:
        return any(r.min_values is not None for r in self.values())

    def __repr__(self) -> str:
        shown = [r for k, r in sorted(self.items()) if k not in wk.RESTRICTED_LABELS]
        return ", ".join(repr(r) for r in shown)


def from_node_selector_requirements(exprs) -> list:
    out = []
    for e in exprs or []:
        if isinstance(e, NodeSelectorRequirement):
            out.append(Requirement(e.key, e.operator, e.values, e.min_values))
        else:  # dict form
            out.append(
                Requirement(
                    e["key"], e["operator"], e.get("values", ()), e.get("minValues")
                )
            )
    return out


def node_selector_requirements(exprs) -> Requirements:
    return Requirements(*from_node_selector_requirements(exprs))


def label_requirements(labels_map: dict) -> Requirements:
    return Requirements(*[Requirement(k, IN, [v]) for k, v in (labels_map or {}).items()])


def _pod_requirements(pod, include_preferred: bool) -> Requirements:
    """requirements.go newPodRequirements:93-113: nodeSelector labels, plus
    the heaviest preferred term (when included), plus the FIRST required
    node-affinity term (outer relaxation loop drops alternatives)."""
    reqs = label_requirements(pod.node_selector)
    aff = pod.affinity
    na = aff.node_affinity if aff else None
    if na is None:
        return reqs
    if include_preferred and na.preferred:
        heaviest = sort_terms_by_weight(na.preferred)[0]
        reqs.add(*from_node_selector_requirements(heaviest.preference.match_expressions))
    if na.required:
        reqs.add(*from_node_selector_requirements(na.required[0].match_expressions))
    return reqs


def pod_requirements(pod) -> Requirements:
    return _pod_requirements(pod, include_preferred=True)


def strict_pod_requirements(pod) -> Requirements:
    return _pod_requirements(pod, include_preferred=False)


def has_preferred_node_affinity(pod) -> bool:
    return bool(
        pod
        and pod.affinity
        and pod.affinity.node_affinity
        and pod.affinity.node_affinity.preferred
    )
