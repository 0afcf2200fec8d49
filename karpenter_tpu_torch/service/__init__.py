"""The two-plane boundary: a gRPC Solver service.

The port's copy of ``karpenter_tpu/service`` (imports changed). The HOST
plane (controllers, store, state) and the DEVICE plane (the solve on the
card) may live in different processes: ``serve()`` runs the device plane
as a gRPC server, and ``RemoteSolver`` is a drop-in ``TorchSolver`` whose
dispatch crosses the wire. Tensorize, decode, validation and the host
fallback stay host-side, so the payload is exactly the dispatch's numpy
kernel arguments and the reply its packed outputs (the seam
``TorchSolver._dispatch`` is in process).

The service is multi-tenant: ``RemoteSolver(..., tenant=)`` speaks the
streaming delta protocol against per-tenant server-side snapshot caches
(session.py), concurrent same-shape solves coalesce into one dispatch on
the card (coalesce.py, ``models/solver.py`` ``batched_invoke``), and
per-tenant budgets and SLO surfaces ride the device plane's telemetry.
The wire format is the JAX package's, so either package's client talks to
either package's server.
"""

from karpenter_tpu_torch.service.coalesce import Coalescer
from karpenter_tpu_torch.service.session import SessionRegistry, TenantSession
from karpenter_tpu_torch.service.solver_service import RemoteSolver, serve

__all__ = [
    "Coalescer",
    "RemoteSolver",
    "SessionRegistry",
    "TenantSession",
    "serve",
]
