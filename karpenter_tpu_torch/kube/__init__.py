from karpenter_tpu_torch.kube.store import KubeStore, Event, ConflictError, NotFoundError, TooManyRequests  # noqa: F401
from karpenter_tpu_torch.kube.binder import Binder  # noqa: F401

__all__ = [
    "KubeStore", "Event", "ConflictError", "NotFoundError", "TooManyRequests",
    "Binder",
]
