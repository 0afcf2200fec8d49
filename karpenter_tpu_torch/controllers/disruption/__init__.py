from karpenter_tpu_torch.controllers.disruption.types import Candidate, Command  # noqa: F401

__all__ = ["Candidate", "Command"]
