"""The engine ladder: which engine runs a dispatch. It decides; the
callers execute.

- ``host_cutoff``: a provisioning batch of at most this many pods runs
  the host FFD loop without tensorizing (``TorchSolver.solve``).
- ``native_reason``: the reason a solve dispatch goes to the native C++
  engine (``karpenter_tpu_torch/native``), or None; then the mesh where
  ``mesh_wanted`` and ``shard_worthy`` hold, else the device
  (``TorchSolver._dispatch``, the solver service's coalesced window).
- ``probe_native``: a consolidation probe snapshot goes to the native
  engine's batched entry (``DisruptionSnapshot.dispatch``).
- ``relax_enabled``: the LP rungs run (``ops/relax.py``,
  ``ops/consolidate.py``).
- ``capture_engine`` and ``replay_rung``: a replay capture's engine name
  and the rung that replays it (``obs/capsule.py``).

Its knobs (``utils/envknobs.py``) are read here and nowhere else, each
once: ``KARPENTER_NATIVE_CUTOFF`` (0 turns ALL routing off),
``KARPENTER_HOST_CUTOFF``, ``KARPENTER_DEVICE_MIN_WORK`` (0 turns the
work floor off), ``KARPENTER_ASSUME_ACCELERATOR`` (1/0 overrides the
device test) and ``KARPENTER_RELAX``.
"""

from __future__ import annotations

import numpy as np
import torch

from karpenter_tpu_torch import native
from karpenter_tpu_torch.utils.envknobs import env_int, env_str

# The JAX package's cutoffs (karpenter_tpu/models/solver.py): pods per
# solve at or below which the native engine runs; pods per batch at or
# below which the host FFD loop runs; real group×type cells below which
# the native engine's short sequential loop finishes first.
NATIVE_CUTOFF_PODS = 192
HOST_CUTOFF_PODS = 8
DEVICE_MIN_WORK = 8192
# feasibility work (G*T*K*W mask cells) above which a multi-device mesh
# earns its overhead; single-card installs never shard
SHARD_MIN_WORK = 1 << 21


def native_cutoff() -> int:
    """The routing master switch (the parity tests pin it to 0)."""
    return env_int("KARPENTER_NATIVE_CUTOFF", NATIVE_CUTOFF_PODS)


def host_cutoff() -> int:
    """The host FFD loop's batch cutoff; 0 when routing is off."""
    if native_cutoff() <= 0:
        return 0
    return env_int("KARPENTER_HOST_CUTOFF", HOST_CUTOFF_PODS)


def _device_min_work() -> int:
    return env_int("KARPENTER_DEVICE_MIN_WORK", DEVICE_MIN_WORK)


def accelerated(device) -> bool:
    """Whether ``device`` is an accelerator (CUDA): on the CPU the plain
    PyTorch path only emulates the device kernel and the native engine
    wins at every size."""
    v = env_str("KARPENTER_ASSUME_ACCELERATOR")
    if v is not None:
        return v.strip().lower() in ("1", "true", "yes", "on")
    return torch.device(device).type == "cuda"


def native_reason(args_np, device) -> str | None:
    """The gate of one solve dispatch, decided on the numpy arguments: the
    reason it goes to the native engine (``small-batch``, ``work-floor``,
    ``cpu-backend``), or None for the device. Counts REAL groups and types
    (padded groups count 0 pods and padded types have no allocatable), so
    routing flips at the calibrated work, not at shape-bucket
    boundaries."""
    cutoff = native_cutoff()
    g_count = np.asarray(args_np["g_count"])
    total = int(g_count.sum())
    if cutoff <= 0 or total <= 0:
        return None
    work = int((g_count > 0).sum()) * int(
        (np.asarray(args_np["t_alloc"]).max(axis=1) > 0).sum())
    if total <= cutoff:
        reason = "small-batch"
    elif work < _device_min_work():
        reason = "work-floor"
    elif not accelerated(device):
        reason = "cpu-backend"
    else:
        return None
    return reason if native.available() else None


def probe_native(G: int, T: int) -> bool:
    """The gate of a probe snapshot of ``G`` groups and ``T`` types: a
    solve's master switch and work floor, on a row's parallelism G×T."""
    if native_cutoff() <= 0 or G * T >= _device_min_work():
        return False
    return native.available()


def relax_enabled(device=None) -> bool:
    """``KARPENTER_RELAX=1`` forces the LP rungs on, ``0`` kills them,
    unset/empty turns them on exactly when ``device`` is ``accelerated``."""
    v = (env_str("KARPENTER_RELAX") or "").strip().lower()
    if v:
        return v not in ("0", "false", "off", "no")
    return device is not None and accelerated(device)


def mesh_wanted(device: torch.device) -> bool:
    """A solver builds a mesh on CUDA with more than one card attached."""
    return device.type == "cuda" and torch.cuda.device_count() > 1


def shard_worthy(args_np) -> bool:
    """A dispatch's feasibility work ``G·T·K·W`` reaches ``SHARD_MIN_WORK``."""
    G, K, W = args_np["g_mask"].shape
    return G * args_np["t_mask"].shape[0] * K * W >= SHARD_MIN_WORK


def capture_engine(engine: str) -> str:
    """A dispatch's engine as a replay capture names it, in the JAX
    package's words: ``native`` and ``remote`` as they are, the device
    types (``cuda``, ``cpu``) as ``device``."""
    return engine if engine in ("native", "remote") else "device"


def replay_rung(engine: str | None) -> str:
    """The rung that replays a capture of ``engine``: the native engine's
    and the mesh's (``partitioned``, ``replicated``) own, else the
    device's."""
    return (engine if engine in ("native", "partitioned", "replicated")
            else "device")
