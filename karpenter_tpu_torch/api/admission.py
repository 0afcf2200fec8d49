"""Admission-layer spec validation — the webhook/CEL analog.

The reference enforces spec legality twice: CEL markers compiled into the
CRDs (hack/validation/*.sh writing kubebuilder rules into
pkg/apis/v1/nodepool.go) and the conversion/validation webhooks
(pkg/webhooks/webhooks.go:82-125). In this hermetic build the apiserver is
the in-memory store, so the same rules run as an admission hook the store
invokes on create/update of NodePools — an invalid spec is REJECTED at
write time (AdmissionError), not merely marked unready later
(controllers/nodepool/validation.py keeps the runtime re-check that folds
into readiness, mirroring the reference's dual layers).

The port's copy of ``karpenter_tpu/api/admission.py`` (imports changed).
"""

from __future__ import annotations

import re

from karpenter_tpu_torch.api import labels as wk

VALID_OPERATORS = {"In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"}
VALID_TAINT_EFFECTS = {"NoSchedule", "PreferNoSchedule", "NoExecute"}
VALID_CONSOLIDATION_POLICIES = {"WhenEmpty", "WhenEmptyOrUnderutilized",
                                "WhenUnderutilized"}
# kubebuilder markers: qualified name, 63-char segments
_LABEL_KEY_RE = re.compile(
    r"^([a-z0-9]([-a-z0-9.]*[a-z0-9])?/)?[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$"
)
_LABEL_VALUE_RE = re.compile(r"^([A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?)?$")


class AdmissionError(ValueError):
    """Spec rejected at admission (webhooks.go denial analog)."""


def _validate_requirement(r, where: str) -> list[str]:
    errs = []
    if not r.key or len(r.key) > 316 or not _LABEL_KEY_RE.match(r.key):
        errs.append(f"{where}: invalid label key {r.key!r}")
    op = getattr(r, "operator", "In")
    if op not in VALID_OPERATORS:
        errs.append(f"{where}: invalid operator {op!r}")
    values = list(getattr(r, "values", ()) or ())
    if op == "In" and not values:
        errs.append(f"{where}: operator In requires values")
    if op in ("Exists", "DoesNotExist") and values:
        errs.append(f"{where}: operator {op} must not carry values")
    if op in ("Gt", "Lt"):
        if len(values) != 1 or not re.fullmatch(r"-?\d+", str(values[0])):
            errs.append(f"{where}: operator {op} requires one integer value")
        elif int(values[0]) < 0:
            errs.append(f"{where}: operator {op} value must be >= 0")
    mv = getattr(r, "min_values", None)
    if mv is not None and not (1 <= mv <= 50):
        errs.append(f"{where}: minValues must be in [1,50]")
    for v in values:
        if len(str(v)) > 63 or not _LABEL_VALUE_RE.match(str(v)):
            errs.append(f"{where}: invalid label value {v!r}")
    return errs


def validate_nodepool_admission(np) -> list[str]:
    """CEL/webhook-layer rules; empty list = admitted."""
    errs = []
    spec = np.spec
    # weight is optional (kubebuilder Minimum=1 Maximum=100); 0 means unset
    if spec.weight and not (1 <= spec.weight <= 100):
        errs.append(f"spec.weight: {spec.weight} outside [1,100]")
    for i, r in enumerate(spec.template.requirements):
        errs.extend(_validate_requirement(r, f"spec.template.requirements[{i}]"))
    for key, value in (spec.template.labels or {}).items():
        # format only: RESTRICTED-label rejection is the runtime validation
        # controller's job (controllers/nodepool/validation.py), mirroring
        # the reference's split — CEL checks shape, the controller checks
        # domain policy and folds it into readiness
        if not _LABEL_KEY_RE.match(key or ""):
            errs.append(f"spec.template.labels: invalid key {key!r}")
        if value is not None and not _LABEL_VALUE_RE.match(str(value)):
            errs.append(f"spec.template.labels[{key}]: invalid value {value!r}")
    for i, t in enumerate(spec.template.taints or ()):
        if t.effect not in VALID_TAINT_EFFECTS:
            errs.append(f"spec.template.taints[{i}]: invalid effect {t.effect!r}")
        if not t.key or not _LABEL_KEY_RE.match(t.key):
            errs.append(f"spec.template.taints[{i}]: invalid key {t.key!r}")
    d = spec.disruption
    if d.consolidation_policy and d.consolidation_policy not in VALID_CONSOLIDATION_POLICIES:
        errs.append(
            f"spec.disruption.consolidationPolicy: {d.consolidation_policy!r}"
        )
    if d.consolidate_after is not None and d.consolidate_after < 0:
        errs.append("spec.disruption.consolidateAfter: must be >= 0")
    expire = getattr(d, "expire_after", None)
    if expire is not None and expire < 0:
        errs.append("spec.disruption.expireAfter: must be >= 0")
    for r, v in (spec.limits or {}).items():
        try:
            from karpenter_tpu_torch.utils.resources import parse_quantity

            if parse_quantity(v) < 0:
                errs.append(f"spec.limits[{r}]: negative")
        except Exception:
            errs.append(f"spec.limits[{r}]: unparseable {v!r}")
    return errs


# PriorityClass admission (the scheduling.k8s.io validation rules): user
# classes live in [-HIGHEST_USER_DEFINABLE, HIGHEST_USER_DEFINABLE]; only
# system- prefixed classes may sit in the positive system-reserved band,
# and the NEGATIVE mirror of that band is reserved-and-unusable for
# everyone (admission/priority.py resolves through the same constants).
HIGHEST_USER_DEFINABLE_PRIORITY = 1_000_000_000
SYSTEM_CLASS_PREFIX = "system-"
VALID_PREEMPTION_POLICIES = {"", "PreemptLowerPriority", "Never"}


def validate_priority_class_admission(pc) -> list[str]:
    errs = []
    value = getattr(pc, "value", 0)
    if not isinstance(value, int) or isinstance(value, bool):
        errs.append(f"value: {value!r} is not an integer")
        return errs
    name = pc.metadata.name or ""
    if value < -HIGHEST_USER_DEFINABLE_PRIORITY:
        # the negative system-reserved range: no class — system or user —
        # may claim it (there is nothing below user priorities to reserve)
        errs.append(
            f"value: {value} is below -{HIGHEST_USER_DEFINABLE_PRIORITY} "
            "(negative system-reserved range)"
        )
    elif value > HIGHEST_USER_DEFINABLE_PRIORITY and not name.startswith(
        SYSTEM_CLASS_PREFIX
    ):
        errs.append(
            f"value: {value} exceeds {HIGHEST_USER_DEFINABLE_PRIORITY} "
            f"(system-reserved; only {SYSTEM_CLASS_PREFIX}* classes may use it)"
        )
    policy = getattr(pc, "preemption_policy", "")
    if policy not in VALID_PREEMPTION_POLICIES:
        errs.append(f"preemptionPolicy: invalid {policy!r}")
    return errs


def admit(kind: str, obj):
    """Store admission hook: raise AdmissionError on an illegal spec."""
    if kind == "nodepools":
        errs = validate_nodepool_admission(obj)
        if errs:
            raise AdmissionError("; ".join(errs))
    elif kind == "priorityclasses":
        errs = validate_priority_class_admission(obj)
        if errs:
            raise AdmissionError("; ".join(errs))
