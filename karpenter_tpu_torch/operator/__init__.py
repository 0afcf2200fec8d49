from karpenter_tpu_torch.operator.environment import Environment  # noqa: F401

__all__ = ["Environment"]
