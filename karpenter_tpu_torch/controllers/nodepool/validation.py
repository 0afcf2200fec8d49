"""NodePool runtime validation.

Mirror of the reference's pkg/controllers/nodepool/validation
(controller.go:46): checks that can only be done at runtime — budget cron
schedules must parse, percentages/counts must be well-formed, requirement
label keys must not be restricted — and records the result as the
ValidationSucceeded condition the readiness controller folds into Ready.

The port's copy of ``karpenter_tpu/controllers/nodepool/validation.py`` (imports changed).
"""

from __future__ import annotations

import re

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.utils.cron import parse_schedule

COND_VALIDATION = "ValidationSucceeded"

_BUDGET_NODES_RE = re.compile(r"((100|[0-9]{1,2})%)|([0-9]+)")


def validate_nodepool(np) -> list[str]:
    """All validation errors for a NodePool spec (empty = valid)."""
    errs = []
    for i, b in enumerate(np.spec.disruption.budgets):
        if b.schedule is not None:
            try:
                parse_schedule(b.schedule)
            except ValueError as e:
                errs.append(f"budgets[{i}].schedule: {e}")
            if b.duration is None:
                errs.append(f"budgets[{i}]: schedule requires duration (CEL rule)")
        elif b.duration is not None:
            errs.append(f"budgets[{i}]: duration requires schedule (CEL rule)")
        # CEL pattern on Budget.Nodes: non-negative integer, or 0-100%
        # (nodepool.go kubebuilder marker ^((100|[0-9]{1,2})(%|$))|([0-9]+)$);
        # a negative count would silently zero allowed_disruptions
        if not _BUDGET_NODES_RE.fullmatch(str(b.nodes).strip()):
            errs.append(f"budgets[{i}].nodes: invalid count/percent {b.nodes!r}")
    for r in np.spec.template.requirements:
        err = wk.is_restricted_label(r.key)
        if err:
            errs.append(f"requirements[{r.key}]: {err}")
    for key in np.spec.template.labels:
        err = wk.is_restricted_label(key)
        if err:
            errs.append(f"labels[{key}]: {err}")
    return errs


class NodePoolValidationController:
    def __init__(self, store, recorder=None):
        self.store = store
        self.recorder = recorder

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        progressed = False
        for np in list(self.store.list("nodepools")):
            errs = validate_nodepool(np)
            want = "False" if errs else "True"
            msg = "; ".join(errs)
            cond = np.get_condition(COND_VALIDATION)
            if cond is None or cond.status != want or cond.message != msg:
                np.set_condition(COND_VALIDATION, status=want,
                                 reason="ValidationFailed" if errs else "ValidationSucceeded",
                                 message=msg)
                self.store.update("nodepools", np)
                if errs and self.recorder is not None:
                    self.recorder.publish("NodePoolValidationFailed", msg, obj=np)
                progressed = True
        return progressed
