from karpenter_tpu_torch.controllers.provisioning.batcher import Batcher  # noqa: F401
from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner  # noqa: F401

__all__ = ["Batcher", "Provisioner"]
