from karpenter_tpu_torch.state.statenode import StateNode  # noqa: F401

__all__ = ["StateNode"]
