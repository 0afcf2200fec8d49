from karpenter_tpu_torch.ops.tensorize import DeviceSnapshot, kernel_args, tensorize  # noqa: F401

__all__ = ["DeviceSnapshot", "kernel_args", "tensorize"]
