from karpenter_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_multihost_mesh,
    sharded_solve,
    sharded_solve_host,
)

__all__ = ["make_mesh", "make_multihost_mesh", "sharded_solve",
           "sharded_solve_host"]
