"""NodePool readiness: Ready condition from the referenced NodeClass.

Mirror of the reference's pkg/controllers/nodepool/readiness
(controller.go:52-100): a NodePool is Ready when its nodeClassRef resolves
to an existing NodeClass whose Ready condition is not False, and runtime
validation (ValidationSucceeded, set by the validation controller) hasn't
failed. The provisioner skips not-Ready pools (provisioner.go:239
OrderByWeight over ready pools).

The port's copy of ``karpenter_tpu/controllers/nodepool/readiness.py`` (imports changed).
"""

from __future__ import annotations

COND_READY = "Ready"
COND_VALIDATION = "ValidationSucceeded"


class NodePoolReadinessController:
    def __init__(self, store):
        self.store = store

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        progressed = False
        for np in list(self.store.list("nodepools")):
            ready, reason, msg = self._readiness(np)
            cond = np.get_condition(COND_READY)
            want = "True" if ready else "False"
            if cond is None or cond.status != want or cond.reason != reason or cond.message != msg:
                np.set_condition(COND_READY, status=want, reason=reason, message=msg)
                self.store.update("nodepools", np)
                progressed = True
        return progressed

    def _readiness(self, np):
        vc = np.get_condition(COND_VALIDATION)
        if vc is not None and vc.status == "False":
            return False, "ValidationFailed", vc.message
        ref = np.spec.template.node_class_ref or {}
        name = ref.get("name")
        if not name:
            return True, "NodeClassRefUnset", ""
        nc = self.store.try_get("nodeclasses", name)
        if nc is None:
            return False, "NodeClassNotFound", f"nodeclass {name} not found"
        if not nc.ready():
            return False, "NodeClassNotReady", f"nodeclass {name} is not ready"
        return True, "NodeClassReady", ""
