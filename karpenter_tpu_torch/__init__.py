"""karpenter_tpu_torch — the PyTorch/CUDA port of karpenter_tpu.

A package of its own beside the JAX one: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``karpenter_tpu``. The host-side modules
(api, scheduling, cloudprovider, the FFD loop, tensorize) are copies of
the JAX package's framework-free modules; the device half
(``ops.kernels``, ``ops.cuda_kernels``, ``models.solver.TorchSolver``)
runs on CUDA unless the caller asks for the CPU.
"""
