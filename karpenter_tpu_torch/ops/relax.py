"""The LP bin floor of the provisioning solve, as plain PyTorch.

The port's copy of the floor half of ``karpenter_tpu/ops/relax.py``
(``lp_bin_floor``, ``_floor_kernel`` and the knobs they read). The
provisioning LP — min total fractional bins such that every group's pods
land on compatible types within their per-resource capacity — is solved
by a diagonally preconditioned primal-dual (PDHG / Chambolle-Pock)
iteration on the solver's device. After the iteration budget the duals
are projected into the dual cone, so weak duality certifies
``ceil(dual objective)`` as a bin lower bound whether or not the primal
converged; ``TorchSolver.plan`` raises its bin-axis estimate with it.

Where the JAX package runs the iteration as one ``lax.while_loop`` over
blocks of ``CHECK_EVERY`` steps with the convergence test on the device,
this copy runs the same blocks as eager PyTorch and reads the convergence
flag back once per block (at most ``MAX_ITERS / CHECK_EVERY`` = 24 host
reads). Every formula keeps the JAX float order; matrix products are
``torch.matmul``.

Knobs (``utils/envknobs.py``), read as the JAX package reads them:

``KARPENTER_RELAX``           ``1`` forces the floor on, ``0`` kills it.
                              Unset = on when the solver's device is CUDA
                              (the JAX package: when its backend is an
                              accelerator), off on the CPU.
``KARPENTER_RELAX_MAX_ITERS`` iteration cap (default 384).
``KARPENTER_RELAX_TOL``       relative convergence tolerance (5e-3).
``KARPENTER_RELAX_RHO``       primal/dual step balance (default 1.0).

Left out (later slices, ROADMAP.md Queue 1): ``joint_relax_plan`` and the
rounding kernel of the consolidation rung.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from karpenter_tpu_torch.utils.envknobs import env_float, env_int, env_str

__all__ = ["relax_enabled", "lp_bin_floor", "floor_inputs", "floor_lb",
           "RELAX_STATS"]

# PDHG steps between convergence checks
CHECK_EVERY = 16
MAX_ITERS = 384

RELAX_STATS = {
    "floor_calls": 0,
    "floor_raises": 0,
    "kernel_ms": 0.0,
    "last_lb": 0.0,
}


def relax_enabled(device=None) -> bool:
    """Tri-state enable: KARPENTER_RELAX=1 forces the floor on, =0 kills
    it, unset/empty turns it on exactly when ``device`` is a CUDA device."""
    v = (env_str("KARPENTER_RELAX") or "").strip().lower()
    if v:
        return v not in ("0", "false", "off", "no")
    return device is not None and torch.device(device).type == "cuda"


def _relax_max_iters() -> int:
    return env_int("KARPENTER_RELAX_MAX_ITERS", MAX_ITERS, minimum=1)


def _relax_tol() -> float:
    return env_float("KARPENTER_RELAX_TOL", 5e-3, minimum=0.0)


def _relax_rho() -> float:
    return max(env_float("KARPENTER_RELAX_RHO", 1.0), 1e-6)


def _pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def floor_lb(d, n, alloc, compat, max_iters: int, tol: float, rho: float):
    """PDHG over the provisioning LP on the tensors' device, then the dual
    projection. ``d[Gp,R]`` per-pod demand, ``n[Gp]`` pod counts,
    ``alloc[Tp,R]`` per-type capacity net of overhead (all equilibrated
    per resource), ``compat[Gp,Tp]`` 0/1 — float32. Returns
    ``(lb, iters)``: the certified fractional bin bound as a 0-d tensor
    and the iterations run."""
    # vars x[Gp,Tp] (pods of g on type t), b[Tp] (fractional bins)
    col_x = (1.0 + d.sum(1))[:, None] * compat
    tau_x = torch.where(col_x > 0, rho / col_x.clamp(min=1e-9), 0.0)
    col_b = alloc.sum(1)
    tau_b = torch.where(col_b > 0, rho / col_b.clamp(min=1e-9), 0.0)
    row_q = compat.sum(1)
    sig_q = torch.where(row_q > 0, 1.0 / (rho * row_q.clamp(min=1e-9)), 0.0)
    row_p = compat.T @ d + alloc
    sig_p = torch.where(row_p > 0, 1.0 / (rho * row_p.clamp(min=1e-9)), 0.0)
    n_tot = n.sum()
    zero = torch.zeros((), dtype=d.dtype, device=d.device)

    x = torch.zeros_like(compat)
    b = torch.zeros_like(col_b)
    q = torch.zeros_like(n)
    p = torch.zeros_like(alloc)
    it = 0
    while it < max_iters:
        b0 = b.sum()
        for _ in range(CHECK_EVERY):
            ktx = -q[:, None] + d @ p.T
            ktb = 1.0 - (alloc * p).sum(1)
            xn = torch.minimum(
                torch.maximum((x - tau_x * ktx) * compat, zero), n[:, None])
            bn = torch.minimum(torch.maximum(b - tau_b * ktb, zero), n_tot)
            xb, bb = 2.0 * xn - x, 2.0 * bn - b
            q = torch.maximum(q + sig_q * (n - xb.sum(1)), zero)
            r_p = xb.T @ d - bb[:, None] * alloc
            p = torch.maximum(p + sig_p * r_p, zero)
            x, b = xn, bn
        it += CHECK_EVERY
        # one host read per block: the JAX while_loop's `done`
        if bool(torch.abs(b.sum() - b0) <= tol * (1.0 + b0)):
            break
    # dual projection — valid regardless of convergence: scale each
    # type's capacity duals into the b-constraint cone, price groups
    # at their cheapest compatible type
    scale = (alloc * p).sum(1).clamp(min=1.0)
    p_hat = p / scale[:, None]
    cost = d @ p_hat.T  # [Gp,Tp]
    cost = torch.where(compat > 0, cost, float("inf"))
    q_hat = cost.amin(1)
    q_hat = torch.where(torch.isfinite(q_hat), q_hat, 0.0)
    return (n * q_hat).sum(), it


def floor_inputs(snap):
    """The floor LP's host tensors for a snapshot: ``(d, n, alloc, compat)``
    as float32 numpy, padded to powers of two (``Gp``, ``Tp`` >= 2) and
    equilibrated per resource — the LP is unit-invariant, the diagonal
    step sizes are not."""
    from karpenter_tpu_torch.ops.consolidate import _group_type_compat

    G, T = snap.G, snap.T
    R = len(snap.resources)
    compat = _group_type_compat(snap)  # [G,T]
    Gp, Tp = _pow2(G, lo=2), _pow2(T, lo=2)
    f32 = np.float32
    d = np.zeros((Gp, R), f32)
    d[:G] = snap.g_demand[:G]
    n = np.zeros(Gp, f32)
    n[:G] = snap.g_count[:G]
    alloc = np.zeros((Tp, R), f32)
    alloc[:T] = np.maximum(
        snap.t_alloc - snap.m_overhead[snap.t_tmpl], 0.0)
    rscale = 1.0 / np.maximum(np.maximum(alloc.max(0), d.max(0)), 1e-12)
    d *= rscale[None, :]
    alloc *= rscale[None, :]
    cm = np.zeros((Gp, Tp), f32)
    cm[:G, :T] = compat
    return d, n, alloc, cm


def lp_bin_floor(snap, est: int, device=None) -> int:
    """A certified bin-count lower bound for one provisioning solve, or
    ``est`` unchanged when the floor is off or inapplicable (fewer than 2
    groups, no type, or G×T above 2^18). ``device`` is the solver's: the
    iteration runs there, and it decides the default of the gate."""
    if not relax_enabled(device):
        return est
    G, T = snap.G, snap.T
    if G < 2 or T < 1 or G * T > (1 << 18):
        return est
    RELAX_STATS["floor_calls"] += 1
    t0 = time.perf_counter()
    dev = torch.device("cpu" if device is None else device)
    d, n, alloc, cm = (torch.from_numpy(a).to(dev) for a in floor_inputs(snap))
    lb_t, _ = floor_lb(d, n, alloc, cm, _relax_max_iters(), _relax_tol(),
                       _relax_rho())
    lb = float(lb_t)
    RELAX_STATS["kernel_ms"] += (time.perf_counter() - t0) * 1000.0
    RELAX_STATS["last_lb"] = lb
    floor = int(np.ceil(lb - 1e-6))
    if floor > est:
        RELAX_STATS["floor_raises"] += 1
        return floor
    return est
