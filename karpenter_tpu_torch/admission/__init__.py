"""Admission plane: priority tiers, preemption, and gang placement.

The subsystem between the provisioner's pending-pod intake and the
solver. Three ladders:

* **Tiered solve** (``plane.py``): the pending batch
  partitions by effective pod priority (``priority.py`` owns the
  resolution matrix) and the existing batched pack runs as a CASCADE —
  high tiers first, each lower tier packing into the residual capacity of
  the same bundle. Residual reuse is literal: the shared ExistingNode
  objects are re-tensorized per tier with their accumulated placements,
  and prior tiers' claims join the existing-node axis through the
  ``residual.ClaimResidual`` adapter, so one compile family (the pow-2
  ladder) serves every tier.
* **Preemption** (``preempt.py``): a high-tier pod
  the cascade could not place builds a counterfactual batch over
  evictable victims — the exact row shape the consolidation probe
  dispatches (``ops/consolidate.py dispatch_counterfactual_rows``, grown
  an ``e_free`` release column) — confirms the winning node by real
  simulation (the host admission pipeline), and evicts through the
  store's PDB-gated eviction subresource the drain path uses.
* **Gang admission** (``gangs.py``): annotation-keyed
  pod-groups place atomically. A gang solves against a FORKED copy of the
  round's state (``fork.py``); a fully-placed trial is promoted wholesale
  (no re-solve, no divergence window), anything less routes the whole
  gang to the pod-error surface with a per-group reason — a partial
  placement can never bind.

``oracle.py`` is the tiered-FFD host oracle the device round's node count
is held against.

The port's copy of ``karpenter_tpu/admission/`` (imports changed; the
preemption probes record the ``preempt.dispatch`` replay capture).
"""

from karpenter_tpu_torch.admission.plane import AdmissionPlane  # noqa: F401
from karpenter_tpu_torch.admission.priority import (  # noqa: F401
    resolve_priority,
    partition_tiers,
)
from karpenter_tpu_torch.admission.oracle import tiered_ffd_oracle  # noqa: F401

__all__ = [
    "AdmissionPlane",
    "resolve_priority",
    "partition_tiers",
    "tiered_ffd_oracle",
]
