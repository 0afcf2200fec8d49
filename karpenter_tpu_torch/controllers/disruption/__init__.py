from karpenter_tpu_torch.controllers.disruption.controller import DisruptionController  # noqa: F401
from karpenter_tpu_torch.controllers.disruption.types import Candidate, Command  # noqa: F401

__all__ = ["DisruptionController", "Candidate", "Command"]
