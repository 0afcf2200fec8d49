"""The LP relaxation rungs, as plain PyTorch on the solver's device.

The port of ``karpenter_tpu/ops/relax.py``. Both combinatorial hot loops —
provisioning bin-packing and the joint consolidation retirement search —
are relaxations of one assignment program, solved here by a diagonally
preconditioned primal-dual (PDHG / Chambolle-Pock) iteration:

- ``lp_bin_floor`` — the provisioning rung: min total fractional bins such
  that every group's pods land on compatible types within their
  per-resource capacity. After the iteration budget the duals are
  projected into the dual cone, so weak duality certifies
  ``ceil(dual objective)`` as a bin lower bound whether or not the primal
  converged; ``TorchSolver.plan`` raises its bin-axis estimate with it.
- ``joint_relax_plan`` — the global-consolidation rung
  (``ops/consolidate.py joint_retirement_plan``): retirement fractions
  ``y[Np]`` over the disruption-cost-ordered candidates (a monotone
  prefix chain), assignment ``x[Gp,Ec]`` of displaced and pending pods
  onto the survivor columns plus one claim-envelope column
  (``Ec = _pow2(E + 1)``). ``k_ub = round(sum(y))`` seeds a rounding
  window that scores ``ROUND_WINDOW`` prefixes at once (``round_window``);
  the host oracle ``_greedy_displace`` materializes the chosen prefix
  exactly, and the shared price criterion gates a claim-bearing prefix.
  Every non-ship outcome hands the round to the FFD ladder with its cause
  in ``RELAX_STATS["last_fallback"]``: ``inexpressible``,
  ``iteration-cap``, ``non-convergence``, ``price-gate`` or
  ``lp-no-retirement``.

Where the JAX package runs an iteration as one ``lax.while_loop`` over
blocks of ``CHECK_EVERY`` steps with the convergence test on the device,
this copy runs the same blocks as eager PyTorch and reads the convergence
flag back once per block (at most ``MAX_ITERS / CHECK_EVERY`` = 24 host
reads). Every formula keeps the JAX float order; matrix products are
``torch.matmul``. The rounding window's ``lax.top_k`` descent becomes a
stable descending sort (ties to the lower column, as ``lax.top_k``
breaks them and the host oracle relies on), its ``lax.scan`` a loop over
the demand-ordered groups with the window as the batch axis.

Both rungs run on the device they are given; ``None`` means CUDA and
raises when no CUDA device is present — neither picks the CPU on its own.

Knobs (``utils/envknobs.py``), read as the JAX package reads them:

``KARPENTER_RELAX``           ``1`` forces the floor on, ``0`` kills it.
                              Unset = on when the solver's device is CUDA
                              (the JAX package: when its backend is an
                              accelerator), off on the CPU. Read by
                              ``ops/engines.py relax_enabled``.
``KARPENTER_RELAX_MAX_ITERS`` iteration cap (default 384).
``KARPENTER_RELAX_TOL``       relative convergence tolerance (5e-3).
``KARPENTER_RELAX_RHO``       primal/dual step balance (default 1.0).

``KARPENTER_RELAX_ROUND_WINDOWS`` rounding windows scanned below the LP
                              bound (default 4).

Each dispatch records the JAX package's compile-ledger key under the
``relax.kernel`` family and its ``relax.grid`` padding
(obs/devplane.py); the joint LP and each rounding window run in the
``relax.solve`` and ``relax.round`` spans, the floor's host tensors in
``relax.inputs`` and its upload, iteration and read in ``relax.floor``
(its iterations summed in ``RELAX_STATS["floor_iters"]``); each ends
after the host read that waits for the device.

Replay capture (obs/capsule.py, seam ``relax.dispatch``): a joint round
that reaches the rounding descent records the LP tensors, the standard
counterfactual-row sidecars and the device window's decision ``k_sel``
(the first flag-passing, price-gated prefix) in the JAX package's layout;
``replay_joint`` re-runs the LP and the windows from the tensors alone,
``replay_host_round`` is the A/B table's host oracle. The LP's ``y`` rides
as the ``cf//rx_y`` sidecar, ungraded: its float32 reductions round
differently on the card, on the CPU and under XLA.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.obs import devplane
from karpenter_tpu_torch.ops.engines import relax_enabled
from karpenter_tpu_torch.ops.kernels import resolve_device
from karpenter_tpu_torch.utils.envknobs import env_float, env_int

__all__ = ["relax_enabled", "lp_bin_floor", "floor_inputs", "floor_lb",
           "joint_relax_plan", "joint_lp", "round_window",
           "rounding_windows", "replay_joint",
           "replay_host_round", "RELAX_STATS"]

# rounding window width: how many candidate prefixes below the LP bound
# one rounding pass scores
ROUND_WINDOW = 8
# exact-materialization attempts: at most this many window prefixes get
# the host oracle pass before the round falls back to the ladder
ROUND_ATTEMPTS = 4
# PDHG steps between convergence checks
CHECK_EVERY = 16
MAX_ITERS = 384
# claim-column objective penalty: prefer delete-only fractional optima
CLAIM_PENALTY = 1e-3
# earlier-candidate tie-break weight spread (keeps the optimum a prefix
# of the disruption-cost order among equal-cardinality solutions)
PREFIX_TIEBREAK = 1e-3

RELAX_STATS = {
    # the joint consolidation rung
    "attempts": 0,
    "ships": 0,
    "fallbacks": 0,
    "rounded_drops": 0,
    "iters": 0,
    "last_fallback": "",
    "last_viol": 0.0,
    "last_k_ub": 0,
    "last_iters": 0,
    "last_k_frac": 0.0,
    # the provisioning floor
    "floor_calls": 0,
    "floor_raises": 0,
    # PDHG iterations over the floor calls (floor_lb's returned count)
    "floor_iters": 0,
    "last_lb": 0.0,
}


def _relax_max_iters() -> int:
    return env_int("KARPENTER_RELAX_MAX_ITERS", MAX_ITERS, minimum=1)


def _relax_tol() -> float:
    return env_float("KARPENTER_RELAX_TOL", 5e-3, minimum=0.0)


def _relax_rho() -> float:
    return max(env_float("KARPENTER_RELAX_RHO", 1.0), 1e-6)


def _relax_round_windows() -> int:
    """KARPENTER_RELAX_ROUND_WINDOWS: how many W-prefix windows the
    rounding descent may scan below the LP bound before handing the
    round to the ladder."""
    return env_int("KARPENTER_RELAX_ROUND_WINDOWS", 4, minimum=1)


def _fallback(cause: str) -> None:
    RELAX_STATS["fallbacks"] += 1
    RELAX_STATS["last_fallback"] = cause


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
        # graftlint: disable=GL101 -- the convergence test, once per
        # 16-iteration block by design: the loop's exit is data-dependent
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
    groups, no type, or G×T above 2^18). ``device`` is the solver's (None
    means CUDA): the iteration runs there, and it decides the default of
    the gate."""
    dev = resolve_device(device, "the LP relax rungs")
    if not relax_enabled(dev):
        return est
    G, T = snap.G, snap.T
    if G < 2 or T < 1 or G * T > (1 << 18):
        return est
    RELAX_STATS["floor_calls"] += 1
    t0 = time.perf_counter()
    with obs.span("relax.inputs"):
        host = floor_inputs(snap)
    with obs.span("relax.floor", kind="device") as sp:
        d, n, alloc, cm = (torch.from_numpy(a).to(dev) for a in host)
        key = (d.shape[0], alloc.shape[0], d.shape[1], True,
               _relax_max_iters(), _relax_tol(), _relax_rho())
        lb_t, iters = floor_lb(d, n, alloc, cm, key[4], key[5], key[6])
        lb = float(lb_t)
        floor = int(np.ceil(lb - 1e-6))
        if sp is not None:
            sp.attrs = dict(iters=iters, Gp=key[0], Tp=key[1],
                            raised=floor > est)
    secs = time.perf_counter() - t0
    devplane.record_dispatch("relax.kernel", ("floor",) + key, secs)
    devplane.record_padding("relax.grid", G * T, key[0] * key[1])
    RELAX_STATS["floor_iters"] += iters
    RELAX_STATS["last_lb"] = lb
    if floor > est:
        RELAX_STATS["floor_raises"] += 1
        return floor
    return est


# ---------------------------------------------------------------------------
# the joint consolidation rung (ops/consolidate.py joint_retirement_plan)
# ---------------------------------------------------------------------------

JOINT_TENSORS = ("d", "capR", "compat", "contrib", "base_req", "w",
                 "colcand", "candidx", "nmask", "gmask", "c_x")


def _clip(x, lo, hi):
    """``jnp.clip``: max with the lower bound, then min with the upper."""
    return torch.minimum(torch.maximum(x, lo), hi)


def joint_lp(t: dict, max_iters: int, tol: float, rho: float,
             with_y: bool = False) -> dict:
    """PDHG over the joint consolidation LP on the tensors' device — the
    JAX package's ``_joint_kernel`` step for step. ``t`` holds the
    ``_joint_tensors`` (float32, ``colcand``/``candidx`` int32).

    Variables: ``x[Gp,Ec]`` (pods of group g on column e; the claim
    envelope is an ordinary column), ``y[Np]`` retirement fractions.
    Constraints (dual in parens): demand coverage per group (``q``),
    per-column per-resource capacity with a retired column's capacity
    scaling away as ``y`` rises (``p``), and the monotone prefix chain
    ``y[c+1] <= y[c]`` (``m``). Blocks of ``CHECK_EVERY`` steps, one host
    read of the convergence flag per block and one of ``viol`` and
    ``sum(y)`` at the end — with ``y`` too when ``with_y`` (a replay
    capture's sidecar). Returns ``y`` (on the device), ``y_host`` (None
    without ``with_y``), ``q``, ``iters``, ``blocks``, ``converged``,
    ``viol``, ``k_frac``."""
    d, capR, compat, contrib = t["d"], t["capR"], t["compat"], t["contrib"]
    base_req, w, nmask, gmask, c_x = (t["base_req"], t["w"], t["nmask"],
                                      t["gmask"], t["c_x"])
    colcand, candidx = t["colcand"].long(), t["candidx"].long()
    Gp, R = d.shape
    Ec = capR.shape[0]
    Np = w.shape[0]
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    one = torch.ones((), dtype=d.dtype, device=d.device)
    z1 = torch.zeros(1, dtype=d.dtype, device=d.device)

    # --- preconditioners ---
    xub = (base_req + contrib.sum(0)) * gmask  # [Gp] max demand
    col_x = (1.0 + d.sum(1))[:, None] * compat  # [Gp,Ec]
    tau_x = torch.where(col_x > 0, rho / col_x.clamp(min=1e-9), 0.0)
    cand_res = capR.sum(1)[candidx]  # [Np] retired column mass
    col_y = contrib.sum(1) + cand_res + 2.0
    tau_y = torch.where(nmask > 0, rho / col_y.clamp(min=1e-9), 0.0)
    row_q = compat.sum(1) + contrib.sum(0)
    sig_q = torch.where(row_q > 0, 1.0 / (rho * row_q.clamp(min=1e-9)), 0.0)
    iscand = (colcand < Np).to(d.dtype)  # [Ec]
    row_p = (compat * 1.0).T @ d + capR * iscand[:, None]
    sig_p = torch.where(row_p > 0, 1.0 / (rho * row_p.clamp(min=1e-9)), 0.0)
    sig_m = 1.0 / (rho * 2.0)
    mpair = nmask[1:] * nmask[:-1]  # [Np-1] real adjacent pairs
    c_y = -w
    xub_col = xub[:, None]

    def kt_mono(m):
        return torch.cat([z1, m]) - torch.cat([m, z1])

    def viol_of(x, y):
        y_col = torch.cat([y, z1])[colcand]
        v_q = ((base_req + y @ contrib - x.sum(1)) * gmask
               / (1.0 + xub)).amax()
        v_p = ((x.T @ d + capR * y_col[:, None] - capR)
               / (1.0 + capR)).amax()
        v_m = ((y[1:] - y[:-1]) * mpair).amax()
        return torch.maximum(torch.maximum(v_q, v_p), v_m)

    x = torch.zeros((Gp, Ec), dtype=d.dtype, device=d.device)
    y = torch.zeros(Np, dtype=d.dtype, device=d.device)
    q = torch.zeros(Gp, dtype=d.dtype, device=d.device)
    p = torch.zeros((Ec, R), dtype=d.dtype, device=d.device)
    m = torch.zeros(Np - 1, dtype=d.dtype, device=d.device)
    it, blocks, done = 0, 0, False
    viol = torch.full((), float("inf"), dtype=d.dtype, device=d.device)
    while not done and it < max_iters:
        y0 = y
        for _ in range(CHECK_EVERY):
            ktx = -q[:, None] + d @ p.T
            p_res = (capR * p).sum(1)  # [Ec]
            kty = contrib @ q + p_res[candidx] + kt_mono(m)
            xn = _clip((x - tau_x * (c_x + ktx)) * compat, zero, xub_col)
            yn = _clip(y - tau_y * (c_y + kty), zero, one) * nmask
            xb, yb = 2.0 * xn - x, 2.0 * yn - y
            y_col = torch.cat([yb, z1])[colcand]  # [Ec]
            r_q = (base_req + yb @ contrib - xb.sum(1)) * gmask
            qn = torch.maximum(q + sig_q * r_q, zero)
            r_p = xb.T @ d + capR * y_col[:, None] - capR
            pn = torch.maximum(p + sig_p * r_p, zero)
            r_m = (yb[1:] - yb[:-1]) * mpair
            mn = torch.maximum(m + sig_m * r_m, zero)
            x, y, q, p, m = xn, yn, qn, pn, mn
        it += CHECK_EVERY
        blocks += 1
        viol = viol_of(x, y)
        dy = torch.abs(y - y0).amax()
        # one host read per block: the JAX while_loop's `done`
        # graftlint: disable=GL101 -- the convergence test, once per
        # 16-iteration block by design: the loop's exit is data-dependent
        done = bool((viol <= tol) & (dy <= tol))
    # graftlint: disable=GL101 -- the one read of the result after the
    # loop (viol, sum(y), and y when a capture needs it), in one buffer
    host = torch.cat([viol.reshape(1), y.sum().reshape(1)]
                     + ([y] if with_y else [])).cpu().numpy()
    return {"y": y, "y_host": host[2:] if with_y else None, "q": q,
            "iters": it,
            "blocks": blocks, "converged": done, "viol": float(host[0]),
            "k_frac": float(host[1])}


def round_window(req_w, surv_w, d, compat, claim_idx: int):
    """The rounding window — the JAX package's ``_round_kernel``: for each
    of W candidate prefixes (required demands ``req_w [W,Gp]`` and
    survivor capacities ``surv_w [W,Ec,R]``, capacity × mask), greedily
    place every group (pre-ordered by demand, the ``_greedy_displace``
    order) into the fullest-fitting survivor columns — a stable descending
    sort, ties to the lower column — with the claim column as the last
    resort. Returns per-window unplaced totals and claim-column usage,
    ``(bad [W], claim [W])``."""
    W = req_w.shape[0]
    Gp = d.shape[0]
    dev, dt = d.device, d.dtype
    resid = surv_w
    bad = torch.zeros(W, dtype=dt, device=dev)
    claim = torch.zeros(W, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    zcol = torch.zeros((W, 1), dtype=dt, device=dev)
    is_claim = torch.arange(compat.shape[1], device=dev) == claim_idx
    for g in range(Gp):
        d_g, n_g, cm_g = d[g], req_w[:, g], compat[g]
        pos = d_g > 0
        n_eff = torch.where(pos.any(), n_g, 0.0)  # [W]
        safe_d = torch.where(pos, d_g, 1.0)
        ratio = torch.where(pos, resid / safe_d, float("inf"))  # [W,Ec,R]
        caps = torch.floor(ratio.amin(-1) + 1e-6)  # [W,Ec]
        # RAW caps rank the descent (the host oracle's sort order)
        caps = torch.where(cm_g > 0, torch.maximum(caps, zero), 0.0)
        # survivors first, the claim column as the last resort
        surv_caps = torch.where(is_claim, 0.0, caps)
        vals, idx = torch.sort(surv_caps, dim=-1, descending=True,
                               stable=True)
        cume = torch.cat([zcol, torch.cumsum(vals, -1)[:, :-1]], dim=-1)
        take_s = _clip(n_eff[:, None] - cume, zero, vals)
        takes = torch.zeros_like(caps).scatter(1, idx, take_s)
        left = torch.maximum(n_eff - takes.sum(-1), zero)
        c_take = torch.minimum(left, caps[:, claim_idx])
        takes = takes + torch.where(is_claim, c_take[:, None], 0.0)
        resid = resid - takes[..., None] * d_g
        bad = bad + torch.maximum(left - c_take, zero)
        claim = claim + c_take
    return bad, claim


def _joint_tensors(bundle, col_arr, contrib, base_req, claim_compat):
    """Host assembly of the joint LP tensors (float32, padded to the pow-2
    family): columns 0..E-1 are the existing-node rows (dead rows
    zero-capacity), column E is the claim envelope, padding columns are
    zero. Returns ``(tensors, (Gp, Ec, Np, R))``."""
    snap, esnap = bundle.snap, bundle.esnap
    G, E, R = snap.G, esnap.E, len(snap.resources)
    N = len(col_arr)
    Gp = _pow2(G)
    Ec = _pow2(E + 1)
    Np = _pow2(max(N, 2), lo=2)
    f32 = np.float32

    d = np.zeros((Gp, R), f32)
    d[:G] = snap.g_demand[:G]
    live = np.asarray(esnap.live, dtype=bool)
    capR = np.zeros((Ec, R), f32)
    capR[:E] = np.maximum(np.asarray(esnap.e_avail, f32), 0.0)
    capR[:E][~live] = 0.0
    if snap.T:
        alloc_eff = snap.t_alloc - snap.m_overhead[snap.t_tmpl]
        capR[E] = np.maximum(alloc_eff.max(axis=0), 0.0)
    # per-resource equilibration: a pure change of units that keeps the
    # diagonal steps away from ~1e-11 (cpu cores vs memory bytes)
    rscale = 1.0 / np.maximum(np.maximum(capR.max(0), d.max(0)), 1e-12)
    d *= rscale[None, :]
    capR *= rscale[None, :]
    compat = np.zeros((Gp, Ec), f32)
    compat[:G, :E] = np.asarray(esnap.ge_ok, bool)[:G, :E] & live[None, :]
    compat[:G, E] = claim_compat[:G]
    contrib_p = np.zeros((Np, Gp), f32)
    contrib_p[:N, :G] = contrib[:, :G]
    base_p = np.zeros(Gp, f32)
    base_p[:G] = base_req[:G]
    w = np.zeros(Np, f32)
    if N > 1:
        w[:N] = 1.0 + PREFIX_TIEBREAK * (N - 1 - np.arange(N)) / (N - 1)
    else:
        w[:N] = 1.0
    # colcand[e] = candidate index retiring column e (Np = none);
    # candidx[c] = column of candidate c (padding points at a dead slot)
    colcand = np.full(Ec, Np, np.int32)
    colcand[col_arr] = np.arange(N, dtype=np.int32)
    candidx = np.full(Np, Ec - 1, np.int32)
    candidx[:N] = col_arr.astype(np.int32)
    nmask = np.zeros(Np, f32)
    nmask[:N] = 1.0
    gmask = np.zeros(Gp, f32)
    gmask[:G] = 1.0
    c_x = np.zeros((Gp, Ec), f32)
    c_x[:G, E] = CLAIM_PENALTY
    return dict(d=d, capR=capR, compat=compat, contrib=contrib_p,
                base_req=base_p, w=w, colcand=colcand, candidx=candidx,
                nmask=nmask, gmask=gmask, c_x=c_x), (Gp, Ec, Np, R)


def rounding_windows(req_of, col_arr, t: dict, E: int, order, k_ub: int,
                     N: int, n_windows: int, device):
    """The bounded rounding descent's windows, shared by the live rung
    (``joint_relax_plan``) and its capsule replay (``replay_joint``). From
    one prefix of headroom above the LP bound ``k_ub`` (the iteration ends
    on primal residual and movement, not on the duality gap), each window
    scores up to ``ROUND_WINDOW`` prefixes k, largest first, in one
    ``round_window`` dispatch on ``device`` over the LP tensors ``t``
    (numpy), their groups in the host oracle's ``order``: prefix k
    retires ``col_arr[:k]`` and needs ``req_of(k)`` pods per group. Yields ``(ks, bad, claim, secs)`` per
    window, ``bad``/``claim`` read back to the host, for at most
    ``n_windows`` windows; the caller ends the descent by leaving the
    loop."""
    G = len(order)
    Gp, Ec = t["compat"].shape
    order_p = np.concatenate([order, np.arange(G, Gp)]).astype(np.intp)
    d_ord = torch.from_numpy(t["d"][order_p]).to(device)
    compat_ord = torch.from_numpy(t["compat"][order_p]).to(device)
    k_lo = int(min(N, k_ub + 1))
    for _ in range(n_windows):
        if k_lo < 2:
            return
        ks = list(range(k_lo, max(1, k_lo - ROUND_WINDOW), -1))
        req_w = np.zeros((ROUND_WINDOW, Gp), np.float32)
        surv_w = np.zeros((ROUND_WINDOW, Ec), np.float32)
        for i, k in enumerate(ks):
            req_w[i, :G] = req_of(k)[order]
            mask = np.ones(Ec, np.float32)
            mask[col_arr[:k]] = 0.0
            surv_w[i] = mask
        # surv rows carry the capacity budget directly (cap * mask)
        surv_w = surv_w[:, :, None] * t["capR"][None, :, :]
        t0 = time.perf_counter()
        with obs.span("relax.round", window=len(ks)):
            bad, claim = round_window(torch.from_numpy(req_w).to(device),
                                      torch.from_numpy(surv_w).to(device),
                                      d_ord, compat_ord, E)
            host = torch.stack([bad, claim]).cpu().numpy()
        yield ks, host[0], host[1], time.perf_counter() - t0
        k_lo = ks[-1] - 1


def joint_relax_plan(bundle, candidates, col_arr, contrib, cum, timings,
                     device=None):
    """The relax fast path of ``joint_retirement_plan``: solve the
    fractional retirement LP on ``device`` (None means CUDA), round
    through the window, price-gate and exactly materialize the winning
    prefix with the FFD oracle. Returns ``(JointPlan, None)`` on a
    shipped plan or ``(None, cause)`` when the round falls to the ladder
    (``cause`` is also in ``RELAX_STATS['last_fallback']``)."""
    from karpenter_tpu_torch.obs import capsule as _capsule
    from karpenter_tpu_torch.ops import consolidate as _cons

    dev = resolve_device(device, "the LP relax rungs")
    RELAX_STATS["attempts"] += 1
    snap = bundle.snap
    G, N = snap.G, len(candidates)
    base = bundle.base
    claimable = bundle.claimable_groups()
    if claimable is None:
        if int(base.sum()):
            # claim accounting can't mirror the simulation: the LP would
            # not be definitive
            _fallback("inexpressible")
            return None, "inexpressible"
        base_req = np.zeros(G, dtype=np.float64)
        claim_compat = np.ones(G, dtype=bool) if snap.T else np.zeros(
            G, dtype=bool)
    else:
        base_req = np.where(claimable[:G], base[:G], 0).astype(np.float64)
        claim_compat = np.asarray(claimable[:G], dtype=bool)

    t0 = time.perf_counter()
    tensors, (Gp, Ec, Np, R) = _joint_tensors(
        bundle, col_arr, contrib, base_req, claim_compat)
    key = (Gp, Ec, Np, R, _relax_max_iters(), _relax_tol(), _relax_rho())
    with obs.span("relax.solve", family=f"{Gp}x{Ec}", n=N):
        t_dev = {k: torch.from_numpy(v).to(dev) for k, v in tensors.items()}
        # y rides the host read only for a replay capture
        out = joint_lp(t_dev, key[4], key[5], key[6],
                       with_y=_capsule.capture_enabled())
    secs = time.perf_counter() - t0
    devplane.record_dispatch("relax.kernel", key, secs)
    devplane.record_padding("relax.grid", G * (bundle.esnap.E + 1) * N,
                            Gp * Ec * Np)
    iters = out["iters"]
    RELAX_STATS["iters"] += iters
    RELAX_STATS["last_iters"] = iters
    RELAX_STATS["last_viol"] = out["viol"]
    RELAX_STATS["last_k_frac"] = out["k_frac"]
    timings["relax_ms"] = timings.get("relax_ms", 0.0) + secs * 1000.0
    timings["relax_lp_ms"] = secs * 1000.0
    timings["relax_blocks"] = out["blocks"]

    if not out["converged"]:
        # a capped exit leaves the fractional point uncertified
        _fallback("iteration-cap")
        return None, "iteration-cap"
    k_ub = int(min(N, np.floor(out["k_frac"] + 0.5)))
    RELAX_STATS["last_k_ub"] = k_ub
    if k_ub < 2:
        _fallback("lp-no-retirement")
        return None, "lp-no-retirement"

    # --- bounded rounding descent: each window scores W prefixes below
    # the LP bound, up to KARPENTER_RELAX_ROUND_WINDOWS windows deep
    n_windows = _relax_round_windows()
    live = np.asarray(bundle.esnap.live, dtype=bool)
    E = bundle.esnap.E
    # the host oracle's group order (raw-unit demand sum, the
    # _greedy_displace sort) — not the equilibrated tensors' order
    order = np.argsort(
        -np.asarray(snap.g_demand, np.float64)[:G].sum(1), kind="stable")
    # price criterion for claim-bearing prefixes — the SAME ladder the
    # FFD path applies
    prefix_known, claim_ok = _cons._prefix_price_ok(bundle, candidates)
    price_blocked = False
    attempts = 0
    chosen = None
    k_dev = 0  # first flag-passing window k — the device decision the
    #            capsule records (host materialization may descend further)
    round_ms = 0.0
    for ks, bad, claim, secs in rounding_windows(
            lambda k: base_req + contrib[:k, :G].sum(axis=0), col_arr,
            tensors, E, order, k_ub, N, n_windows, dev):
        devplane.record_dispatch("relax.kernel", ("round",) + key, secs)
        round_ms += secs * 1000.0
        timings["relax_ms"] += secs * 1000.0
        for i, k in enumerate(ks):
            if k < 2 or bad[i] > 0.5:
                continue
            claim_used = bool(claim[i] > 0.5)
            if claim_used and not (prefix_known[k - 1]
                                   and claim_ok[k - 1]):
                price_blocked = True
                continue
            if k_dev == 0:
                k_dev = k
            if attempts >= ROUND_ATTEMPTS:
                break
            attempts += 1
            surv = live.copy()
            surv[col_arr[:k]] = False
            required = base_req.copy()
            required[:G] += contrib[:k, :G].sum(axis=0)
            plan = _cons._greedy_displace(
                bundle, surv, required, allow_claim=claim_used,
                max_claims=_cons._replace_max_claims())
            if plan is not None:
                chosen = (k, plan, claim_used)
                break
        if chosen is not None or attempts >= ROUND_ATTEMPTS:
            break
    timings["relax_round_ms"] = round_ms
    cause = None
    if chosen is None:
        cause = "price-gate" if price_blocked else "non-convergence"
        _fallback(cause)
    _capture_joint(bundle, candidates, col_arr, contrib, cum, base_req,
                   tensors, out, key, k_dev,
                   0 if chosen is None else chosen[0],
                   prefix_known, claim_ok, order)
    if chosen is None:
        return None, cause
    k_final, (placements, overflow, n_claims), _ = chosen
    dropped = max(k_ub - k_final, 0)
    RELAX_STATS["ships"] += 1
    RELAX_STATS["rounded_drops"] += dropped
    prefix_feasible = np.zeros(N, dtype=bool)
    prefix_feasible[:k_final] = True
    plan = _cons.JointPlan(
        candidates,
        selected_idx=range(k_final),
        delete_only=not overflow,
        definitive=True,
        displacement=placements,
        overflow=overflow,
        n_claims=n_claims,
        k_device=k_ub,
        dropped=dropped,
        timings=timings,
        prefix_feasible=prefix_feasible,
        single_mask=None,
        generation=bundle.generation,
        transient=False,
        solver="relax",
    )
    return plan, None


def _capture_joint(bundle, candidates, col_arr, contrib, cum, base_req,
                   tensors, out, key, k_dev, k_shipped,
                   prefix_known, claim_ok, order):
    """Record the ``relax.dispatch`` capsule seam: the LP tensors (the
    relax rung's replay inputs) merged with the standard
    counterfactual-row sidecars and the shared numpy snapshot, so the A/B
    table can race the relax rung against the FFD ladder and the host-FFD
    oracle on ONE capture. The captured ``k_sel`` is the device window's
    selection; the prefix the round shipped (which may descend further on
    ``_greedy_displace`` refusals) rides as the ``k_shipped`` static. The
    LP's ``y`` (read back with ``k_frac``) is the ungraded ``rx_y``
    sidecar (module docstring)."""
    from karpenter_tpu_torch.obs import capsule as _capsule

    if not _capsule.capture_enabled():
        return
    from karpenter_tpu_torch.ops.consolidate import row_capture_inputs

    G, N = bundle.snap.G, len(candidates)
    shared, (Gp_probe, Ep_probe) = bundle._shared_host()
    # the standard row sidecars: row k retires the first k+1 candidates
    inputs = row_capture_inputs(
        shared, bundle.base[None, :] + cum, bundle.esnap.e_avail,
        [col_arr[: k + 1] for k in range(N)])
    required = np.repeat(base_req[None, :G], N, axis=0)
    required += np.cumsum(contrib[:, :G], axis=0)
    cf = _capsule.CF_PREFIX
    for name in JOINT_TENSORS:
        inputs[cf + "rx_" + name] = tensors[name]
    inputs[cf + "rx_required"] = required
    inputs[cf + "rx_col_arr"] = col_arr.astype(np.int64)
    # the host oracle's group order (raw-unit demand) — equilibrated
    # tensors can't reproduce it, so it rides the capture
    inputs[cf + "rx_order"] = np.asarray(order, np.int64)
    inputs[cf + "rx_claim_gate"] = (
        np.asarray(prefix_known, bool) & np.asarray(claim_ok, bool))
    inputs[cf + "rx_y"] = out["y_host"]
    _capsule.record_capture(
        "relax.dispatch", inputs, {"k_sel": np.int64(k_dev)},
        engine="relax", max_minv=bundle.max_minv,
        Gp=Gp_probe, Ep=Ep_probe, k_shipped=int(k_shipped),
        rx_shape=list(key[:4]), rx_iters=key[4], rx_tol=key[5],
        rx_rho=key[6], rx_windows=_relax_round_windows(),
        rx_n=N, rx_g=G, rx_e=bundle.esnap.E)


# ---------------------------------------------------------------------------
# capsule replay entries (obs/capsule.py "relax.dispatch" seam)
# ---------------------------------------------------------------------------


def replay_joint(cap, device) -> dict:
    """Re-run the captured LP and rounding decision on ``device``: the
    same iteration, the same knob values (from the capture statics, not
    the live environment), the same price-gate bits. Returns
    ``{"k_sel"}``, the device window's selection."""
    iters = int(cap.static("rx_iters"))
    tol = float(cap.static("rx_tol"))
    rho = float(cap.static("rx_rho"))
    N = int(cap.static("rx_n"))
    E = int(cap.static("rx_e"))
    t = {n: np.asarray(cap.sidecar("rx_" + n)) for n in JOINT_TENSORS}
    out = joint_lp({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in t.items()}, iters, tol, rho)
    k_sel = 0
    if out["converged"]:
        k_ub = int(min(N, np.floor(out["k_frac"] + 0.5)))
        if k_ub >= 2:
            n_windows = int(cap.static("rx_windows", 1))
            col_arr = np.asarray(cap.sidecar("rx_col_arr"))
            claim_gate = np.asarray(cap.sidecar("rx_claim_gate"))
            order = np.asarray(cap.sidecar("rx_order"))
            req_all = np.asarray(cap.sidecar("rx_required"))
            for ks, bad, claim, _ in rounding_windows(
                    lambda k: req_all[k - 1], col_arr, t, E, order, k_ub,
                    N, n_windows, device):
                k_sel = next((k for i, k in enumerate(ks)
                              if k >= 2 and bad[i] <= 0.5
                              and (claim[i] <= 0.5 or claim_gate[k - 1])),
                             0)
                if k_sel:
                    break
    return {"k_sel": np.int64(k_sel)}


def replay_host_round(cap) -> dict:
    """The host-FFD oracle leg of the A/B table: pure-numpy greedy
    prefix descent over the captured LP tensors — largest prefix whose
    displaced pods place integrally (f64, the _greedy_displace
    arithmetic), price-gated identically. The JAX package's, copied."""
    N = int(cap.static("rx_n"))
    G = int(cap.static("rx_g"))
    d = np.asarray(cap.sidecar("rx_d"), dtype=np.float64)[:G]
    capR = np.asarray(cap.sidecar("rx_capR"), dtype=np.float64)
    compat = np.asarray(cap.sidecar("rx_compat")).astype(bool)[:G]
    col_arr = np.asarray(cap.sidecar("rx_col_arr"))
    req_all = np.asarray(cap.sidecar("rx_required"), dtype=np.float64)
    claim_gate = np.asarray(cap.sidecar("rx_claim_gate"))
    E = int(cap.static("rx_e"))
    order = np.asarray(cap.sidecar("rx_order"))
    k_sel = 0
    for k in range(N, 1, -1):
        resid = capR.copy()
        resid[col_arr[:k]] = 0.0
        required = req_all[k - 1]
        ok = True
        claim_used = False
        for g in order:
            n = float(required[g])
            if n <= 0:
                continue
            dg = d[g]
            pos = dg > 0
            if not pos.any():
                continue
            rows = np.flatnonzero(compat[g])
            # survivors-first, claim as last resort — the same tiering
            # as _greedy_displace and the device window kernel
            surv_rows = rows[rows < E]
            caps = np.floor(
                (resid[np.ix_(surv_rows, np.flatnonzero(pos))]
                 / dg[pos][None, :]).min(axis=1) + 1e-9)
            for j in np.argsort(-caps, kind="stable"):
                if n <= 0:
                    break
                take = min(n, caps[j])
                if take <= 0:
                    break
                resid[surv_rows[j]] -= take * dg
                n -= take
            if n > 0 and (rows >= E).any():
                e = int(rows[rows >= E][0])
                ccap = float(np.floor(
                    (resid[e][pos] / dg[pos]).min() + 1e-9))
                take = min(n, ccap)
                if take > 0:
                    claim_used = True
                    resid[e] -= take * dg
                    n -= take
            if n > 0:
                ok = False
                break
        if ok and claim_used and not claim_gate[k - 1]:
            ok = False
        if ok:
            k_sel = k
            break
    return {"k_sel": np.int64(k_sel)}
