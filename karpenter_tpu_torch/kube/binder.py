"""Minimal kube-scheduler stand-in for the hermetic cluster.

The reference relies on the real kube-scheduler to bind pods onto nodes it
launches (SURVEY.md §3.2 final step); its tests bind manually
(expectations.go ExpectProvisioned:276). Our in-memory cluster needs an
actual binder so the end-to-end loop closes: pending pods land on ready,
compatible nodes — preferring the node they were nominated onto — and pods
the binder cannot place get the Unschedulable condition the provisioner
watches for.

The port's copy of ``karpenter_tpu/kube/binder.py`` (imports changed).
"""

from __future__ import annotations

import time

from karpenter_tpu_torch.scheduling import Taints, label_requirements, pod_requirements
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.utils import pod as pod_util
from karpenter_tpu_torch.utils import resources as resutil

# process-wide binding accounting, delta'd by `python -m perf global`
# (the rebind_ms half of the post-command wave's breakdown)
STATS = {
    "rebind_ms": 0.0,
    "passes": 0,
    "bound": 0,
    "hinted": 0,  # binds landed via a consolidation wave hint
}

# Wave hints: node name -> displaced-pod count the consolidation round's
# displacement plan routed there (ops/consolidate.py JointPlan
# .displacement, seeded by the disruption controller post-confirm).
# Evicted pods are deleted and re-created by the workload controller, so
# hints key by TARGET NODE, not pod identity: the binder tries hinted
# survivors first and lets ``_fits`` validate — a stale or wrong hint
# falls through to the normal cursor scan, costing nothing but the one
# check. Consumption is destructive (counts decrement per bind) so a
# hint never outlives its wave. This is the device-side rebinding lever
# of the fused cluster round (deploy/README.md "Fused cluster round").
WAVE_HINTS: dict = {}


def seed_wave_hints(entries) -> int:
    """Merge ``(node_name, count)`` pairs into the wave-hint table;
    returns the number of hinted slots now outstanding."""
    for name, count in entries:
        if count > 0:
            WAVE_HINTS[name] = WAVE_HINTS.get(name, 0) + int(count)
    return sum(WAVE_HINTS.values())


def _shape_key(pod, pod_req) -> tuple:
    """Binding-equivalence key: two pods with the same key see the same
    ``_fits`` answer on every node (requests, tolerations, and the
    node_selector/affinity that ``pod_requirements`` reads). Affinity
    groups by object identity — clone-stamped replicas share their spec
    sub-objects by reference, so the deployment wave (the case the cursor
    exists for) collapses to one key, while structurally-equal-but-
    distinct affinities merely get their own cursor (correct, just less
    shared)."""
    return (
        tuple(sorted(pod_req.items())),
        tuple(sorted((pod.node_selector or {}).items())),
        tuple((t.key, t.operator, t.value, t.effect)
              for t in pod.tolerations),
        id(pod.affinity) if pod.affinity is not None else None,
    )


class Binder:
    _hint_hit = None  # node the last successful _try_hints landed on

    def __init__(self, store, clock=None, registry=None):
        from karpenter_tpu_torch.operator import metrics as _m
        from karpenter_tpu_torch.utils.clock import Clock

        self.store = store
        self.clock = clock or Clock()
        self.registry = registry or _m.REGISTRY

    def _fits(self, pod, node, available: dict, node_view: dict,
              pod_req, pod_reqs) -> bool:
        if not node.ready or node.unschedulable or node.metadata.deletion_timestamp:
            return False
        view = node_view.get(node.name)
        if view is None:
            # per-pass memo: requirement/taint objects are per NODE, but
            # the scan tests every (pod, node) pair — rebuilding them per
            # pair made the binder O(pods × nodes × labels) and dominated
            # fleet-scale benches after a consolidation wave
            view = node_view[node.name] = (
                Taints(t for t in node.taints
                       if t.effect in ("NoSchedule", "NoExecute")),
                label_requirements(node.labels),
            )
        taints, node_reqs = view
        if taints.tolerates(pod):
            return False
        if node_reqs.compatible(pod_reqs, allow_undefined=wk.WELL_KNOWN_LABELS):
            return False
        return resutil.fits(pod_req, available[node.name])

    def bind_pending(self) -> int:
        """One binding pass; returns the number of pods progressed."""
        pending = [
            p
            for p in self.store.list("pods")
            if not p.node_name and p.metadata.deletion_timestamp is None
        ]
        if not pending:
            return 0  # idle tick: no trace, no work
        t0 = time.perf_counter()
        # a binding pass is the root of its own reconcile round (obs
        # flight recorder) — the scheduler stand-in's analog of the
        # provisioner's solve round
        from karpenter_tpu_torch import obs

        with obs.round_trace("bind", registry=self.registry,
                             pending=len(pending)):
            progressed = self._bind(pending)
        STATS["rebind_ms"] += (time.perf_counter() - t0) * 1000.0
        STATS["passes"] += 1
        STATS["bound"] += progressed
        return progressed

    def _try_hints(self, pod, nodes, available, node_view, pod_req,
                   pod_reqs) -> bool:
        """Hint-first placement: try the CURRENT head of the wave-hint
        table before the cursor scan — at most one extra ``_fits`` check
        per pod, so a wave of wrong hints can never cost more than one
        probe each (the cursor scan below stays the ground truth and
        keeps its O(pods + nodes)-per-shape bound). A hit consumes one
        hinted slot (destructive); a miss rotates the head to the back so
        one cold node cannot shadow the rest of the wave's hints."""
        while WAVE_HINTS:
            hname = next(iter(WAVE_HINTS))
            hnode = nodes.get(hname)
            if hnode is None:
                del WAVE_HINTS[hname]  # node retired mid-wave: hint dead
                continue
            if self._fits(pod, hnode, available, node_view, pod_req,
                          pod_reqs):
                WAVE_HINTS[hname] -= 1
                if WAVE_HINTS[hname] <= 0:
                    del WAVE_HINTS[hname]
                STATS["hinted"] += 1
                self._hint_hit = hnode
                return True
            # rotate: re-insert at the back (dicts preserve order)
            WAVE_HINTS[hname] = WAVE_HINTS.pop(hname)
            return False
        return False

    def _bind(self, pending: list) -> int:
        progressed = 0
        node_view: dict = {}  # node name -> (Taints, label Requirements)
        from karpenter_tpu_torch import obs

        with obs.span("bind.availability"):
            nodes = {n.name: n for n in self.store.list("nodes")}
            # availability computed once per pass, decremented as pods bind
            used: dict = {name: {} for name in nodes}
            for p in self.store.list("pods"):
                if p.node_name in used and p.metadata.deletion_timestamp is None:
                    used[p.node_name] = resutil.merge(
                        used[p.node_name], p.effective_requests())
            available = {
                name: resutil.subtract(nodes[name].allocatable, used[name])
                for name in nodes
            }

        # nominated pods get first crack at their reserved capacity
        pending.sort(key=lambda p: not p.nominated_node_name)
        node_order = list(nodes.values())
        # per-shape scan cursor: within one pass, availability only ever
        # DECREASES, and a node's taints/labels are fixed — so a node that
        # refused a pod can never accept a spec-identical pod later in the
        # same pass. Remembering, per pod shape, how far the scan has
        # proven the node order infeasible turns a consolidation wave
        # (thousands of clone-stamped replicas re-binding at once) from
        # O(pods × nodes) into O(pods + nodes) per shape — the scan that
        # dominated the 2k-node global-consolidation bench.
        cursor: dict = {}
        for pod in pending:
            placed = False
            # pod-side objects built once per pod, not once per (pod, node)
            pod_req = pod.effective_requests()
            pod_reqs = pod_requirements(pod)
            nominated = nodes.get(pod.nominated_node_name)
            if nominated is not None and self._fits(
                    pod, nominated, available, node_view, pod_req, pod_reqs):
                placed = True
                node = nominated
            elif WAVE_HINTS and self._try_hints(
                    pod, nodes, available, node_view, pod_req, pod_reqs):
                placed = True
                node = self._hint_hit
            else:
                key = _shape_key(pod, pod_req)
                start = cursor.get(key, 0)
                for i in range(start, len(node_order)):
                    node = node_order[i]
                    if node is nominated:
                        continue
                    if self._fits(pod, node, available, node_view, pod_req,
                                  pod_reqs):
                        # the node may still have room: same-shape scans
                        # resume HERE, not past it
                        cursor[key] = i
                        placed = True
                        break
                else:
                    cursor[key] = len(node_order)
            if placed:
                self.store.bind(pod, node.name)
                available[node.name] = resutil.subtract(
                    available[node.name], pod_req
                )
                # creation → bound latency (the reference's pod startup
                # duration summary, controllers/metrics/pod)
                if pod.metadata.creation_timestamp:
                    from karpenter_tpu_torch.operator import metrics as m

                    self.registry.histogram(
                        m.PODS_STARTUP_DURATION,
                        "seconds from pod creation to binding",
                    ).observe(self.clock.now() - pod.metadata.creation_timestamp)
                progressed += 1
                continue
            target = nominated
            if (
                target is not None
                and target.ready
                and target.metadata.deletion_timestamp is None
                and not any(t.key == wk.UNREGISTERED_TAINT_KEY for t in target.taints)
            ):
                # nominated node is settled but can no longer take the pod
                # (capacity stolen) — drop the dead nomination so the
                # provisioner re-solves
                pod.nominated_node_name = ""
                self.store.update("pods", pod)
                progressed += 1
            elif not pod_util.failed_to_schedule(pod):
                # mark Unschedulable like the real scheduler would — this is
                # the condition the provisioner watches for
                pod.conditions.append(
                    {"type": "PodScheduled", "status": "False", "reason": "Unschedulable"}
                )
                self.store.update("pods", pod)
                progressed += 1
        return progressed
