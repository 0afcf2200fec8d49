"""First-fit-decreasing pod queue with staleness detection.

Mirrors the reference's scheduling queue (pkg/controllers/provisioning/
scheduling/queue.go:37-76): pods ordered by CPU then memory descending,
Pop returns False once the queue has cycled without progress, Push after a
relaxation resets staleness tracking.
"""

from __future__ import annotations

from collections import deque

from karpenter_tpu_torch.utils import resources as resutil


def _sort_key(pod):
    req = pod.effective_requests()
    return (-req.get(resutil.CPU, 0.0), -req.get(resutil.MEMORY, 0.0))


class SchedulingQueue:
    def __init__(self, pods):
        self.pods = deque(sorted(pods, key=_sort_key))
        self._last_len: dict = {}

    def pop(self):
        if not self.pods:
            return None
        p = self.pods[0]
        # cycled through the whole queue without progress → stop
        if self._last_len.get(p.uid) == len(self.pods):
            return None
        self.pods.popleft()
        return p

    def push(self, pod, relaxed: bool):
        self.pods.append(pod)
        if relaxed:
            self._last_len = {}
        else:
            self._last_len[pod.uid] = len(self.pods)

    def __len__(self):
        return len(self.pods)
