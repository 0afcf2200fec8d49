from karpenter_tpu_torch.models.inflight import ClaimTemplate, InFlightNodeClaim  # noqa: F401
from karpenter_tpu_torch.models.queue import SchedulingQueue  # noqa: F401
from karpenter_tpu_torch.models.scheduler import Scheduler, SchedulerResults  # noqa: F401
from karpenter_tpu_torch.models.solver import HostSolver, Solver, TorchSolver  # noqa: F401

__all__ = [
    "ClaimTemplate", "InFlightNodeClaim", "SchedulingQueue", "Scheduler",
    "SchedulerResults", "HostSolver", "Solver", "TorchSolver",
]
