"""Orchestration queue: command execution lifecycle.

Mirror of the reference's pkg/controllers/disruption/orchestration/queue.go:
after a command is admitted — candidates tainted, replacements launched —
the queue waits for every replacement NodeClaim to initialize, then deletes
the candidate claims (:165-294). Commands that cannot complete within
`MAX_RETRY_DURATION` roll back: candidates are untainted and unmarked so
provisioning/disruption see them as healthy again (:56, :226-294);
replacement claims are left for the emptiness path to reap.

The port's copy of ``karpenter_tpu/controllers/disruption/queue.py`` (imports changed).
"""

from __future__ import annotations

import time

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.objects import Taint

MAX_RETRY_DURATION = 10 * 60.0  # queue.go:56

# process-wide command-orchestration accounting, delta'd by
# `python -m perf global` (the orchestrate_ms slice of the post-command
# wave's breakdown — replacement waits, candidate-claim deletion,
# rollbacks; the drain and rebind halves live in
# controllers/node/termination.py and kube/binder.py STATS)
STATS = {
    "orchestrate_ms": 0.0,
    "polls": 0,
}

DISRUPTION_TAINT = Taint(
    key=wk.DISRUPTION_TAINT_KEY, value=wk.DISRUPTION_TAINT_VALUE, effect="NoSchedule"
)


def add_disruption_taint(store, node) -> bool:
    if any(t.key == wk.DISRUPTION_TAINT_KEY for t in node.taints):
        return False
    node.taints.append(DISRUPTION_TAINT)
    store.update("nodes", node)
    return True


def remove_disruption_taint(store, node) -> bool:
    kept = [t for t in node.taints if t.key != wk.DISRUPTION_TAINT_KEY]
    if len(kept) == len(node.taints):
        return False
    node.taints = kept
    store.update("nodes", node)
    return True


class OrchestrationQueue:
    def __init__(self, store, cluster, clock, recorder=None):
        self.store = store
        self.cluster = cluster
        self.clock = clock
        self.recorder = recorder
        self.commands: list = []

    def has_candidate(self, provider_id: str) -> bool:
        return any(
            c.provider_id == provider_id for cmd in self.commands for c in cmd.candidates
        )

    def add(self, command):
        command.created_at = self.clock.now()
        self.commands.append(command)

    def poll(self) -> bool:
        if not self.commands:
            return False
        t0 = time.perf_counter()
        progressed = False
        remaining = []
        for cmd in self.commands:
            done, moved = self._reconcile(cmd)
            progressed |= moved
            if not done:
                remaining.append(cmd)
        self.commands = remaining
        STATS["orchestrate_ms"] += (time.perf_counter() - t0) * 1000.0
        STATS["polls"] += 1
        return progressed

    def _reconcile(self, cmd) -> tuple:
        """(done, progressed) — wait replacements Initialized, then delete
        candidates (queue.go waitOrTerminate:226)."""
        if self.clock.now() - cmd.created_at > MAX_RETRY_DURATION:
            self._rollback(cmd)
            return True, True
        for name in cmd.replacement_names:
            claim = self.store.try_get("nodeclaims", name)
            if claim is None:
                # a replacement died (e.g. insufficient capacity, liveness):
                # unrecoverable — roll back (queue.go:268)
                self._rollback(cmd)
                return True, True
            if not claim.initialized:
                return False, False  # keep waiting
        # all replacements ready: delete the candidates
        for c in cmd.candidates:
            claim = c.state_node.node_claim
            if claim is None:
                continue
            existing = self.store.try_get("nodeclaims", claim.name)
            if existing is not None and existing.metadata.deletion_timestamp is None:
                self.store.delete("nodeclaims", existing)
        if self.recorder is not None:
            self.recorder.publish(
                "DisruptionTerminating",
                f"{cmd.reason}: deleting {[c.name for c in cmd.candidates]}",
            )
        return True, True

    def _rollback(self, cmd):
        """Untaint + unmark so the cluster returns to steady state
        (queue.go:272-294)."""
        cmd.last_error = "command timed out or replacement failed"
        for c in cmd.candidates:
            node = self.store.try_get("nodes", c.name)
            if node is not None:
                remove_disruption_taint(self.store, node)
        self.cluster.unmark_for_deletion(*[c.provider_id for c in cmd.candidates])
        if self.recorder is not None:
            self.recorder.publish(
                "DisruptionFailed", f"rolled back command for {[c.name for c in cmd.candidates]}"
            )
