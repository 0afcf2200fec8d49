from karpenter_tpu_torch.models.inflight import ClaimTemplate, InFlightNodeClaim  # noqa: F401
from karpenter_tpu_torch.models.queue import SchedulingQueue  # noqa: F401
from karpenter_tpu_torch.models.scheduler import Scheduler, SchedulerResults  # noqa: F401
from karpenter_tpu_torch.models.solver import (  # noqa: F401
    HostSolver,
    NativeSolver,
    Solver,
    TorchSolver,
    make_solver,
)

__all__ = [
    "ClaimTemplate", "InFlightNodeClaim", "SchedulingQueue", "Scheduler",
    "SchedulerResults", "HostSolver", "NativeSolver", "Solver", "TorchSolver",
    "make_solver",
]
