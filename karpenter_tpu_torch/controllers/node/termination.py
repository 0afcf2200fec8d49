"""Node termination: the graceful drain finalizer.

Mirror of the reference's pkg/controllers/node/termination
(controller.go:70-170) + terminator (terminator.go:51-109,
eviction.go:129-193): a deleting node is tainted, its evictable pods are
evicted through the PDB-gated Eviction subresource (429s retried on later
polls), and only when the drain completes does the finalizer release the
node object. Daemonset- and node-owned pods are not evicted — they die with
the node.

Batched drain wave: a consolidation command retires whole
node SETS, so one poll may face thousands of deleting nodes. The old
per-node reconcile rescanned the full pod list per node (O(deleting ×
pods) — it dominated the 2k-node global-consolidation wave) and paid a
full PDB recount per eviction. Now each poll builds ONE pods-by-node
index, collects every node's evictable pods, and ships them through the
store's :meth:`~karpenter_tpu_torch.kube.store.KubeStore.evict_wave` — one
PDB-checked wave with memoized allowances, semantically identical to
sequential per-pod evictions in the same order. The wave opens a
``drain`` flight-recorder round (``drain.evict`` / ``drain.finalize``
spans), records the fleet ledger's ``evict`` and ``retire`` events, and
feeds the module ``STATS`` (``evict_ms``, ``drain_ms``).

The port's copy of ``karpenter_tpu/controllers/node/termination.py``
(imports changed).
"""

from __future__ import annotations

import time

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.obs import timeline
from karpenter_tpu_torch.controllers.disruption.queue import add_disruption_taint
from karpenter_tpu_torch.utils import pod as pod_util

# process-wide drain accounting, delta'd by `python -m perf global`
STATS = {
    "evict_ms": 0.0,  # time inside the PDB-checked eviction wave
    "drain_ms": 0.0,  # whole drain poll (evict + finalizer decisions)
    "evict_waves": 0,
    "evicted": 0,
    "evict_blocked": 0,
}


class NodeTerminationController:
    def __init__(self, store, clock=None, recorder=None, registry=None):
        from karpenter_tpu_torch.operator import metrics as _m
        from karpenter_tpu_torch.utils.clock import Clock

        self.store = store
        self.clock = clock or Clock()
        self.recorder = recorder
        self.registry = registry or _m.REGISTRY

    def on_event(self, event):
        pass

    def poll(self) -> bool:
        deleting = [
            node
            for node in self.store.list("nodes")
            if node.metadata.deletion_timestamp is not None
            and wk.TERMINATION_FINALIZER in node.metadata.finalizers
        ]
        if not deleting:
            return False
        t0 = time.perf_counter()
        # the drain wave is the root of its own reconcile round, like the
        # binder's pass: the post-command orchestration's wall clock is
        # attributable from its span tree instead of vanishing between
        # disruption rounds
        with obs.round_trace("drain", registry=self.registry,
                             nodes=len(deleting)):
            progressed = self._drain_wave(deleting)
            if not progressed:
                obs.discard_round()  # pure waiting: no story this tick
        STATS["drain_ms"] += (time.perf_counter() - t0) * 1000.0
        return progressed

    def _drain_wave(self, deleting) -> bool:
        progressed = False
        plan = []  # (node, evictable pods) in store order
        wave = []
        with obs.span("drain.evict", kind="host", nodes=len(deleting)):
            # ONE pods-by-node index per poll instead of a full pod scan
            # per deleting node
            pods_by_node: dict = {}
            for pod in self.store.list("pods"):
                if pod.node_name:
                    pods_by_node.setdefault(pod.node_name, []).append(pod)
            for node in deleting:
                if add_disruption_taint(self.store, node):
                    progressed = True
                evictable = [
                    pod
                    for pod in pods_by_node.get(node.name, ())
                    if pod.metadata.deletion_timestamp is None
                    and not pod.owned_by_daemonset()
                    and not pod_util.is_owned_by_node(pod)
                    and pod_util.is_evictable(pod)
                ]
                plan.append((node, evictable))
                wave.extend(evictable)
            t1 = time.perf_counter()
            evicted, blocked = self.store.evict_wave(wave)
            STATS["evict_ms"] += (time.perf_counter() - t1) * 1000.0
            STATS["evict_waves"] += 1
            STATS["evicted"] += len(evicted)
            STATS["evict_blocked"] += len(blocked)
        if evicted:
            progressed = True
        blocked_keys = {p.key() for p in blocked}
        # evict events stage on the drain round's trace: an eviction always
        # means progress, so the round keeps and the events commit
        for node, evictable in plan:
            n = sum(1 for p in evictable if p.key() not in blocked_keys)
            if n:
                timeline.record_event("evict", node.name, pods=n)
        with obs.span("drain.finalize", kind="host"):
            for node, evictable in plan:
                if evictable:
                    # still draining; PDB-blocked pods retry on a later
                    # poll (eviction.go 429 path)
                    if self.recorder is not None:
                        for pod in evictable:
                            if pod.key() in blocked_keys:
                                self.recorder.publish(
                                    "EvictionBlocked",
                                    f"pdb blocks eviction of {pod.key()}",
                                )
                    continue
                if self._finalize(node):
                    progressed = True
        return progressed

    def _finalize(self, node) -> bool:
        """Drain complete for this node: hold for attached CSI volumes,
        else release the termination finalizer (unchanged semantics from
        the per-node reconcile)."""
        if self._blocking_volume_attachments(node):
            # drain done but CSI volumes still attached: hold the finalizer
            # until the attach/detach controller catches up, so a stateful
            # workload's data is flushed before the instance disappears
            # (the reference's await-volume-detach step between drain and
            # finalizer release)
            if self.recorder is not None:
                self.recorder.publish(
                    "AwaitingVolumeDetachment",
                    f"volumes still attached to {node.name}",
                )
            return False
        node.metadata.finalizers = [
            f for f in node.metadata.finalizers if f != wk.TERMINATION_FINALIZER
        ]
        self.store.update("nodes", node)
        # lifecycle counters + graceful-drain latency (the reference's
        # NodesTerminatedCounter + TerminationSummary, termination
        # controller removeFinalizer)
        from karpenter_tpu_torch.operator import metrics as m

        pool = node.labels.get(wk.NODEPOOL_LABEL, "")
        self.registry.counter(m.NODES_TERMINATED, "nodes terminated").inc(
            nodepool=pool)
        # retire closes the node's timeline (and counts a reclaim when an
        # interrupt notice preceded it — the observed interruption feed)
        timeline.record_event(
            "retire", node.name, pool=pool,
            instance_type=node.labels.get(wk.INSTANCE_TYPE_LABEL, ""),
            zone=node.labels.get(wk.TOPOLOGY_ZONE_LABEL, ""),
            registry=self.registry)
        if node.metadata.deletion_timestamp is not None:
            self.registry.histogram(
                m.NODE_TERMINATION_DURATION,
                "seconds from node deletion to finalizer release",
            ).observe(self.clock.now() - node.metadata.deletion_timestamp,
                      nodepool=pool)
        return True

    def _blocking_volume_attachments(self, node) -> list:
        """VolumeAttachments on this node that gate finalizer release.
        Attachments whose PV is used only by pods that survive the drain
        (daemonset- or node-owned) never detach, so they don't block."""
        vas = [
            va
            for va in self.store.list("volumeattachments")
            if va.node_name == node.name and va.metadata.deletion_timestamp is None
        ]
        if not vas:
            return []
        from karpenter_tpu_torch.scheduling.volumes import VolumeUsage

        undrainable_pvs = set()
        for pod in self.store.list("pods"):
            if pod.node_name != node.name:
                continue
            if not (pod.owned_by_daemonset() or pod_util.is_owned_by_node(pod)):
                continue
            for _csi, vol_id in VolumeUsage.pod_volumes(pod, kube=self.store):
                undrainable_pvs.add(vol_id)
        return [va for va in vas if va.pv_name not in undrainable_pvs]
