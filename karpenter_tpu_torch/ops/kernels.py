"""Feasibility + grouped bin-packing as PyTorch on an explicit device.

The port of ``karpenter_tpu/ops/kernels.py``. Same formulation, same
formulas, in the same float order, so every integer output is the floor of
the same f32 expression and matches the JAX package bit for bit:

- ``feasibility`` builds ``F[G,T]`` = requirement compat ∧ resource fit ∧
  an available, zone- and capacity-type-allowed offering, plus the
  cheapest offering ``price[G,T]`` and the template overlap
  ``tmpl_full[G,M]``. Both compat products go through
  ``ops.cuda_kernels.compat``: the hand-written CUDA kernel for tensors on
  the card, its plain version for tensors on the CPU.
- ``pack`` is the FFD scan over pod groups. ``lax.scan`` becomes a Python
  loop over the group rows. Each row's compat against the open bins
  (phase B) goes through ``compat`` too, as a ``[1,B]`` product. Nothing
  inside the loop reads a value back to the host (no ``.item()``, no
  ``bool(tensor)``, no boolean-mask indexing), so on the card the whole
  solve queues asynchronously and the caller reads one buffer back.
- ``pack`` carries a leading row axis ``N`` on every piece of state that
  a counterfactual changes: the group counts, the existing nodes'
  availability and load, and every bin. ``solve_step`` is the ``N = 1``
  case; ``probe_step`` is the consolidation probe, the JAX package's
  ``jax.vmap`` of ``solve_step`` over ``{g_count, e_avail}``
  (``karpenter_tpu/ops/consolidate.py`` ``_batched_kernel``): feasibility
  runs once for all rows, the pack loop once over the group rows with
  every row's bins in one ``[1, N·B]`` compat product per group row, so
  a chunk costs the launches of one solve whatever its row count. A pick
  by ``argmax`` becomes a gather along the row axis.

Where the two frameworks differ and this module compensates:

- float→int32 casts saturate in XLA (inf → INT_MAX, -inf → INT_MIN,
  NaN → 0) and do not in torch: every floor→int32 site goes through
  ``sat_int32``;
- ``torch.cumsum``/``torch.sum`` of int32 return int64: every integer
  reduction passes ``dtype=torch.int32``;
- CUDA has few uint32 kernels: every bitmask is carried as int32 bit
  patterns (``from_kernel_args``), and only ``&``, ``|`` and ``!= 0`` are
  applied to them;
- a 0-d tensor used as an index may be read back to the host: rows picked
  by a device-side argmax go through ``index_select``/``gather``;
- XLA on the CPU contracts a multiply feeding an add in one fused loop into
  a fused multiply-add (one rounding of ``a·b + c``); torch rounds the
  product and the sum apart. The sites, read from the object code of the
  JAX package's compiled solve and probe (``XLA_FLAGS=--xla_dump_to``,
  jax 0.9.0 on x86-64): ``load2`` (``load + take·d``), ``new_load``
  (``overhead + pods_new·d``) and ``eload2`` in every program; the
  nodepool-limit debit ``rem[m*] + (−worst)·n_opened`` in the solve (a
  dynamic-update-slice fusion) but not in the probe (a scatter-add of the
  product); the capacity formula ``ad − load·inv_d`` in the solve when the
  bin and type axes have the same length (otherwise LLVM hoists the
  product out of the vectorised type loop) and never in the probe. The
  batched solve (``jit(vmap(packed))`` over stacked snapshots, the solver
  service's coalesced dispatch) contracts ``load2``, ``new_load``,
  ``eload2`` and the capacity formula as the solve does (the formula only
  when the two axes match) and scatter-adds the debit, as the probe does.
  ``pack`` computes those sites with ``fma32``, the rest op by op, so a
  capacity at a float tie floors as the reference's does. ``fma32`` forms
  the product exactly in float64 (two 24-bit significands fit in 53
  bits), adds in float64 with round-to-odd (the exact residual from
  TwoSum; an inexact even sum steps one ulp toward it), and rounds to
  float32 once: round-to-odd at 53 bits followed by round-to-nearest at
  24 is the correctly rounded result, so no double rounding. These are
  plain float64 torch ops, IEEE on the CPU and on the card alike, so the
  two stay bit-equal; ``torch.addcmul`` was not used because whether it
  rounds once depends on how each build's kernel was compiled.
"""

from __future__ import annotations

import numpy as np
import torch

from karpenter_tpu_torch.ops.cuda_kernels import compat
from karpenter_tpu_torch.ops.tensorize import SPREAD_OWNED_MIN, UNCAPPED

_EPS = 1e-6
_LEVEL_SEARCH_ITERS = 20  # supports levels up to ~1M pods per bin

_I32 = torch.int32
_F32 = torch.float32
_INT32_MAX = 2**31 - 1
_INT32_MIN = -(2**31)


def resolve_device(device, what: str) -> torch.device:
    """``device``, or CUDA when None — raising when no CUDA device is
    present, as ``TorchSolver()`` does: ``what`` (named in the message)
    never drops to the CPU on its own; ``device="cpu"`` is the plain
    PyTorch path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} run on CUDA and no CUDA device is present; pass "
                "device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` for float32 tensors (broadcasting), rounded once to
    float32 — XLA's contracted multiply-add. The product is exact in
    float64; the float64 sum is made round-to-odd from its TwoSum residual
    before the one rounding to float32. Infinite sums pass through."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - c
    err = (c - (s - bb)) + (p - bb)  # p + c == s + err exactly
    bits = s.view(torch.int64)
    even_inexact = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    # one ulp toward the exact sum: up in magnitude iff err has s's sign
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where(even_inexact, bits + step, bits)
    return bits.view(torch.float64).to(_F32)


def sat_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 the way XLA converts: values at or above 2^31 (and
    +inf) give INT32_MAX, values below -2^31 (and -inf) give INT32_MIN,
    NaN gives 0, everything else truncates toward zero. The bounds are
    compared, never clamped, in f32: 2147483647.0 rounds up to 2^31."""
    hi = x >= 2147483648.0
    lo = x < -2147483648.0
    bad = hi | lo | torch.isnan(x)
    out = torch.where(bad, torch.zeros_like(x), x).to(_I32)
    out = torch.where(hi, _INT32_MAX, out)
    return torch.where(lo, _INT32_MIN, out)


def from_kernel_args(args: dict, device) -> dict:
    """A ``kernel_args`` dict of numpy arrays (the JAX package's or the
    port's) → tensors on ``device``, with the dtypes JAX gives them in
    32-bit mode: uint32 masks reinterpreted as int32 bit patterns, int64 →
    int32, float64 → float32, bools kept as bool, shapes unchanged."""
    out = {}
    for k, v in args.items():
        a = np.ascontiguousarray(np.asarray(v))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        elif a.dtype == np.float64:
            a = a.astype(np.float32)
        out[k] = torch.from_numpy(a).to(device)
    return out


def feasibility(
    g_mask,  # [G,K,W] i32 bit patterns
    g_has,  # [G,K] bool
    g_demand,  # [G,R] f32
    t_mask,  # [T,K,W] i32
    t_has,  # [T,K] bool
    t_alloc,  # [T,R] f32
    g_zone_allowed,  # [G,Vz] bool
    g_ct_allowed,  # [G,Vc] bool
    off_zone,  # [T,O] i32
    off_ct,  # [T,O] i32
    off_avail,  # [T,O] bool
    off_price,  # [T,O] f32
    g_tmpl_ok,  # [G,M] bool (taints + custom-label definedness)
    m_mask,  # [M,K,W] i32
    m_has,  # [M,K] bool
    g_tol=None,  # [G,K] bool NotIn/DoesNotExist operators
    t_tol=None,  # [T,K] bool
    m_tol=None,  # [M,K] bool
):
    """Returns (F [G,T] bool, price [G,T] f32, tmpl_full [G,M] bool)."""
    G, K, _ = g_mask.shape
    T = t_mask.shape[0]
    dev = g_mask.device
    if g_tol is None:
        g_tol = torch.zeros((G, K), dtype=torch.bool, device=dev)
    if t_tol is None:
        t_tol = torch.zeros((T, K), dtype=torch.bool, device=dev)
    if m_tol is None:
        m_tol = torch.zeros((m_mask.shape[0], K), dtype=torch.bool, device=dev)

    # requirement overlap, key by key; an empty meet is tolerated iff BOTH
    # operators are NotIn/DoesNotExist (requirements.py Intersects)
    compat_gt = compat(g_mask, g_has, g_tol, t_mask, t_has, t_tol)

    # resource fit: every demanded resource within allocatable
    fits = (g_demand[:, None, :] <= t_alloc[None, :, :] + _EPS).all(-1)

    # offerings: available ∧ zone allowed ∧ capacity-type allowed
    zo = torch.where(
        off_zone[None, :, :] >= 0,
        g_zone_allowed[:, off_zone.clamp(min=0).long()], True,
    )  # [G,T,O]
    co = torch.where(
        off_ct[None, :, :] >= 0,
        g_ct_allowed[:, off_ct.clamp(min=0).long()], True,
    )
    off_ok = off_avail[None, :, :] & zo & co  # [G,T,O]
    has_off = off_ok.any(-1)
    price = torch.where(off_ok, off_price[None, :, :], float("inf")).amin(-1)

    F = compat_gt & fits & has_off

    # template-level requirement overlap for new-bin placement (the same
    # Intersects tolerance applies)
    tmpl_full = g_tmpl_ok & compat(g_mask, g_has, g_tol, m_mask, m_has, m_tol)
    return F, price, tmpl_full


def _combine_masks(a_mask, a_has, b_mask, b_has):
    """Requirement-set union with per-key intersection of allowed values.
    a:[...,K,W]/[...,K]; b broadcastable to a."""
    both = a_has & b_has
    out_mask = torch.where(
        both[..., None], a_mask & b_mask,
        torch.where(b_has[..., None], b_mask, a_mask),
    )
    return out_mask, a_has | b_has


def _level_fill(q, npods, n, level_bits: int = _LEVEL_SEARCH_ITERS):
    """Distribute n[i] pods of each row i across its bins filling
    emptiest-first up to per-bin caps q (the reference's
    ascending-pod-count claim ordering). q/npods ``[N,B]`` (npods may
    broadcast), n ``[N]``; returns the per-bin take ``[N,B]``. The binary
    search over the water level runs ``level_bits`` unrolled steps of
    device dataflow — no host reads. A single row (q ``[B]``, n 0-d) is
    the N = 1 case."""
    if n.dim() == 0:
        return _level_fill(q[None], npods[None], n[None], level_bits)[0]
    total_cap = q.sum(-1, dtype=_I32)
    n_eff = torch.minimum(n, total_cap)
    lo = torch.zeros_like(n_eff)
    hi = torch.full_like(n_eff, 1 << level_bits)
    for _ in range(level_bits):
        mid = (lo + hi) // 2
        enough = torch.minimum(q, (mid[:, None] - npods).clamp(min=0)).sum(
            -1, dtype=_I32) >= n_eff
        lo = torch.where(enough, lo, mid)
        hi = torch.where(enough, mid, hi)
    level = hi[:, None]
    take = torch.minimum(q, (level - npods).clamp(min=0))
    # overshoot: bins whose take reaches the final level can each give back 1
    excess = take.sum(-1, dtype=_I32) - n_eff
    cand = (take > 0) & (npods + take == level)
    give_back = cand & (torch.cumsum(cand.to(_I32), -1, dtype=_I32)
                        <= excess[:, None])
    return take - give_back.to(_I32)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx[i]]`` for every row i, for a device index ``[N]`` — an
    argmax pick without a host read."""
    return x.index_select(0, idx)


def pack(
    # per-group rows, already in FFD order
    g_demand,  # [G,R] f32
    g_count,  # [N,G] i32: the row axis
    g_mask,  # [G,K,W] i32
    g_has,  # [G,K] bool
    F,  # [G,T] feasibility
    tmpl_full,  # [G,M]
    g_bin_cap,  # [G] i32: max pods of the group per bin (waves topology)
    g_single,  # [G] bool: whole group confined to one bin
    g_decl,  # [G,CW] i32: hostname-anti classes the group declares
    g_match,  # [G,CW] i32: hostname-anti classes whose selector matches it
    g_sown,  # [G,C] i32: per-bin cap where the group owns the spread class
    g_smatch,  # [G,C] bool: the spread class counts this group's pods
    g_aneed,  # [G,A] bool: hostname-affinity classes the group owns
    g_amatch,  # [G,A] bool: the affinity-class selector matches this group
    g_tier,  # [G] i32: priority tier (rows arrive tier-major)
    # existing/in-flight nodes as pre-loaded bins
    ge_ok,  # [G,E] bool
    e_avail,  # [N,E,R] f32: the row axis
    e_npods,  # [E] i32
    e_scnt,  # [E,C] i32
    e_decl,  # [E,CW] i32
    e_match,  # [E,CW] i32
    e_aff,  # [E,A] i32
    # static catalog
    t_alloc,  # [T,R]
    t_cap,  # [T,R]
    t_tmpl,  # [T] i32
    m_mask,  # [M,K,W] i32
    m_has,  # [M,K]
    m_overhead,  # [M,R]
    m_limits,  # [M,R]
    m_minv,  # [M] i32: required distinct instance types per claim
    *,
    max_bins: int,
    with_existing: bool = True,
    level_bits: int = _LEVEL_SEARCH_ITERS,
    max_minv: int = 0,
    fma_cap: bool = False,
    fma_rem: bool = True,
):
    """Grouped greedy pack — the JAX ``pack`` step for step (see its
    docstring for the semantics of every class and gate), for N rows at
    once: row i packs ``g_count[i]`` onto ``e_avail[i]`` and bins of its
    own, and no row reads another's state. ``fma_cap``/``fma_rem`` say
    whether the capacity formula and the nodepool-limit debit round once
    (``fma32``), as the reference's compiled program does at this shape
    (module docstring). Returns dict with assign
    [N,G,B] i32, assign_e [N,G,E] i32, used [N,B] bool, npods [N,B] i32,
    types [N,B,T] bool, tmpl [N,B] i32, tier [N,B] i32."""
    dev = g_demand.device
    G, R = g_demand.shape
    N = g_count.shape[0]
    T = t_alloc.shape[0]
    M = m_overhead.shape[0]
    B = max_bins
    E = e_avail.shape[1]
    K, W = g_mask.shape[1:]
    CW = g_decl.shape[1]
    C = g_sown.shape[1]
    A = g_aneed.shape[1]
    inf = float("inf")
    t_tmpl_l = t_tmpl.long()
    ar_M = torch.arange(M, device=dev)
    t_is_m = t_tmpl_l[:, None] == ar_M[None, :]  # [T,M]
    ar_B = torch.arange(B, device=dev)
    # static per-type check: template overhead fits the type's allocatable
    # on EVERY dim (a group's d=0 dims never re-check it inside the loop)
    ovh_ok = (m_overhead[t_tmpl_l] <= t_alloc + _EPS).all(-1)  # [T]
    # new-bin capacity shared by every row
    fresh_avail = t_alloc - m_overhead[t_tmpl_l]  # [T,R]

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    used = zeros((N, B), torch.bool)
    npods = zeros((N, B), _I32)
    load = zeros((N, B, R), _F32)
    types = zeros((N, B, T), torch.bool)
    bmask = zeros((N, B, K, W), _I32)
    bhas = zeros((N, B, K), torch.bool)
    btmpl = zeros((N, B), _I32)
    rem = m_limits.to(_F32)[None].expand(N, M, R).clone()  # [N,M,R]
    bdecl = zeros((N, B, CW), _I32)
    bmatch = zeros((N, B, CW), _I32)
    bscnt = zeros((N, B, C), _I32)
    baff = zeros((N, B, A), _I32)
    # tier of the group that OPENED the bin (observability only)
    btier = zeros((N, B), _I32)
    if with_existing:
        # shared node state broadcasts over the rows until a take lands
        eload = zeros((N, E, R), _F32)
        enpods = e_npods.to(_I32)[None]
        escnt = e_scnt.to(_I32)[None]
        edecl = e_decl[None]
        ematch = e_match[None]
        eaff = e_aff.to(_I32)[None]
    assign = zeros((N, G, B), _I32)
    assign_e = zeros((N, G, E), _I32)
    no_tol_g = zeros((1, K), torch.bool)
    no_tol_b = zeros((N * B, K), torch.bool)

    for g in range(G):
        d = g_demand[g]
        n = g_count[:, g]  # [N]
        gm, gh = g_mask[g], g_has[g]
        Fg, tfull = F[g], tmpl_full[g]
        cap_g, single = g_bin_cap[g], g_single[g]
        decl_g, match_g = g_decl[g], g_match[g]
        sown_g, smatch_g = g_sown[g], g_smatch[g]
        aneed_g, amatch_g = g_aneed[g], g_amatch[g]
        any_aneed = aneed_g.any()
        has_pods = n > 0  # [N]
        owned = sown_g < SPREAD_OWNED_MIN  # [C]
        smatch_i = smatch_g.to(_I32)
        amatch_i = amatch_g.to(_I32)

        # ---- phase A: existing nodes first ----
        if with_existing:
            avail_e = e_avail - eload  # [N,E,R]
            ratio_e = torch.where(d > 0, avail_e / d.clamp(min=_EPS), inf)
            q_e = sat_int32(torch.floor(ratio_e.amin(-1) + _EPS))  # [N,E]
            anti_e = ((ematch & decl_g) == 0).all(-1) & (
                (edecl & match_g) == 0
            ).all(-1)
            rem_e = sown_g - escnt  # [N,E,C]
            rem_e_eff = torch.where(
                smatch_g, rem_e, (rem_e > 0).to(_I32) * UNCAPPED
            )
            q_cls_e = torch.where(owned, rem_e_eff, UNCAPPED).amin(-1)
            aff_e = (~aneed_g | (eaff > 0)).all(-1)
            q_e = torch.where(ge_ok[g] & anti_e & aff_e, q_e, 0)
            q_e = torch.minimum(torch.minimum(q_e, cap_g), q_cls_e.clamp(min=0))
            q_e = torch.where(single | ~has_pods[:, None], 0, q_e)
            take_e = _level_fill(q_e, enpods, n, level_bits)  # [N,E]
            n = n - take_e.sum(-1, dtype=_I32)

            eload = fma32(take_e[..., None].to(_F32), d, eload)
            enpods = enpods + take_e
            escnt = escnt + take_e[..., None] * smatch_i
            eaff = eaff + take_e[..., None] * amatch_i
            landed_e = (take_e > 0)[..., None]
            edecl = torch.where(landed_e, edecl | decl_g, edecl)
            ematch = torch.where(landed_e, ematch | match_g, ematch)
            assign_e[:, g] = take_e

        # ---- phase B: open claim bins: compatibility ----
        # the group row against every row's bins, no tolerance: the compat
        # kernel at [1, N·B]
        compat_b = compat(gm[None], gh[None], no_tol_g,
                          bmask.view(N * B, K, W), bhas.view(N * B, K),
                          no_tol_b).view(N, B)
        compat_b = compat_b & used & tfull[btmpl.long()]
        anti_ok = ((bmatch & decl_g) == 0).all(-1) & (
            (bdecl & match_g) == 0
        ).all(-1)
        compat_b = compat_b & anti_ok
        aff_ok = (~aneed_g | (baff > 0)).all(-1)
        compat_b = compat_b & aff_ok

        # ---- per-bin capacity for this group (max over remaining types) ----
        # the reciprocal, then multiplies — the JAX formula, kept for its
        # float order
        inv_d = torch.where(d > 0, torch.ones_like(d) / d.clamp(min=_EPS), 0.0)
        ad = torch.where(d > 0, t_alloc * inv_d, inf)  # [T,R]
        if fma_cap:
            # ad − load·inv_d in one rounding, the product on [N,B,R]
            room = fma32(load[:, :, None], -inv_d, ad)  # [N,B,T,R]
        else:
            room = ad[None, None] - (load * inv_d)[:, :, None]
        cap_bt = sat_int32(torch.floor(room.amin(-1) + _EPS))  # [N,B,T]
        cap_bt = torch.where(types & Fg, cap_bt.clamp(min=0), 0)
        q = cap_bt.amax(-1)  # [N,B]
        q = torch.where(compat_b, q, 0)
        q = torch.minimum(q, cap_g)
        rem_cls = sown_g - bscnt  # [N,B,C]
        rem_eff = torch.where(
            smatch_g, rem_cls, (rem_cls > 0).to(_I32) * UNCAPPED
        )
        q_cls = torch.where(owned, rem_eff, UNCAPPED).amin(-1)  # [N,B]
        q = torch.minimum(q, q_cls.clamp(min=0))
        if max_minv > 0:
            # minValues floor: a take of t keeps >= minv instance types
            # alive iff t <= the minv-th largest per-type capacity
            minv_b = m_minv[btmpl.long()]  # [N,B]
            k_eff = min(max_minv, T)
            top = torch.topk(cap_bt, k_eff, dim=-1).values  # [N,B,k_eff] desc
            idx = (minv_b - 1).clamp(0, k_eff - 1)
            kth = torch.gather(top, -1, idx[..., None].long())[..., 0]
            kth = torch.where(minv_b > T, 0, kth)
            q = torch.where(minv_b > 0, torch.minimum(q, kth.clamp(min=0)), q)

        take = _level_fill(q, npods, n, level_bits)
        # single-bin group: everything lands on the single highest-capacity
        # bin (first maximum, as jnp.argmax)
        b_star = torch.argmax(q, dim=-1)  # [N]
        take_single = torch.where(
            ar_B == b_star[:, None], torch.minimum(q.amax(-1), n)[:, None], 0)
        take = torch.where(single, take_single, take)
        take = torch.where(has_pods[:, None], take, 0)
        assigned = take.sum(-1, dtype=_I32)  # [N]
        spill = n - assigned

        # ---- new bins from the best template ----
        fr = torch.where(d > 0, fresh_avail / d.clamp(min=_EPS), inf)
        fresh_cap = sat_int32(torch.floor(fr.amin(-1) + _EPS))  # [T]
        limit_ok = (t_cap <= rem[:, t_tmpl_l] + _EPS).all(-1)  # [N,T]
        new_ok = Fg & limit_ok & tfull[t_tmpl_l] & (fresh_cap > 0) & ovh_ok
        fc = torch.where(new_ok[..., None] & t_is_m, fresh_cap[:, None], 0)  # [N,T,M]
        per_node_m = fc.amax(1)  # [N,M]
        if max_minv > 0:
            # a fresh claim must also open with >= minv viable types
            k_eff = min(max_minv, T)
            topm = torch.topk(fc.transpose(1, 2), k_eff, dim=-1).values  # [N,M,k]
            idx_m = (m_minv - 1).clamp(0, k_eff - 1).long()
            kth_m = torch.gather(topm, -1, idx_m[None, :, None].expand(N, M, 1))[..., 0]
            kth_m = torch.where(m_minv > T, 0, kth_m)
            per_node_m = torch.where(
                m_minv > 0, torch.minimum(per_node_m, kth_m.clamp(min=0)),
                per_node_m,
            )
        feasible_m = per_node_m > 0
        # templates are pre-sorted by weight: first feasible wins
        m_star = torch.argmax(feasible_m.to(_I32), dim=-1)  # [N]
        any_m = feasible_m.any(-1)
        cap_own = torch.where(owned & smatch_g, sown_g, UNCAPPED).amin()
        per_node = torch.minimum(
            torch.gather(per_node_m, 1, m_star[:, None])[:, 0],
            torch.minimum(cap_g, cap_own),
        ).clamp(min=1)  # [N]

        # worst-case capacity of a new bin (for limit accounting, below)
        is_star = t_tmpl_l == m_star[:, None]  # [N,T]
        worst = torch.where((new_ok & is_star)[..., None], t_cap, 0.0).amax(1)  # [N,R]
        # cap bin openings by the nodepool's remaining limits
        star_idx = m_star[:, None, None].expand(N, 1, R)
        rem_star = torch.gather(rem, 1, star_idx)[:, 0]  # [N,R]
        limit_ratio = torch.where(worst > 0, rem_star / worst, inf)
        max_new_by_limit = sat_int32(
            torch.floor(limit_ratio.amin(-1) + _EPS).clamp(0, 2**30)
        )

        want_new = torch.where(
            any_m & (spill > 0), (spill + per_node - 1) // per_node, 0
        )
        # single-bin group: one new bin, and only if nothing placed on an
        # existing bin
        want_new = torch.where(
            single, ((assigned == 0) & any_m & (spill > 0)).to(_I32), want_new
        )
        # affinity owners may open exactly ONE fresh bin, and only to
        # bootstrap a class with zero matches anywhere
        gc = baff.sum(1, dtype=_I32)  # [N,A]
        if with_existing:
            gc = gc + eaff.sum(1, dtype=_I32)
        boot_ok = (~aneed_g | (amatch_g & (gc == 0))).all(-1)  # [N]
        want_new = torch.where(any_aneed & ~boot_ok, 0, want_new)
        want_new = torch.where(any_aneed, want_new.clamp(max=1), want_new)
        want_new = torch.minimum(want_new, max_new_by_limit)
        free = ~used
        rank = torch.cumsum(free.to(_I32), -1, dtype=_I32) - 1  # [N,B]
        sel = free & (rank < want_new[:, None])
        pods_new = torch.minimum(
            (spill[:, None] - rank * per_node[:, None]).clamp(min=0),
            per_node[:, None],
        ) * sel.to(_I32)

        # ---- commit: existing bins ----
        upd = take > 0
        npods2 = npods + take
        # a surviving type still fits iff its capacity covered the take
        fits_new = cap_bt >= take[..., None]  # [N,B,T]
        types2 = torch.where(upd[..., None], types & Fg & fits_new, types)
        cm, ch = _combine_masks(bmask, bhas, gm, gh)
        bmask2 = torch.where(upd[..., None, None], cm, bmask)
        bhas2 = torch.where(upd[..., None], ch, bhas)

        # ---- commit: new bins ----
        new_types = (
            is_star[:, None, :]
            & new_ok[:, None, :]
            & (fresh_cap >= pods_new[..., None])
        )
        # new bin requirements = template ∧ group
        nm, nh = _combine_masks(_rows(m_mask, m_star), _rows(m_has, m_star),
                                gm, gh)  # [N,K,W], [N,K]
        used = used | sel
        npods = torch.where(sel, pods_new, npods2)
        # load2 = load + take·d on the open bins, new_load = overhead +
        # pods_new·d on the new ones, each one rounding: the select
        # commutes with the elementwise multiply-add, so one fma32 does both
        load = fma32(torch.where(sel, pods_new, take)[..., None].to(_F32), d,
                     torch.where(sel[..., None],
                                 _rows(m_overhead, m_star)[:, None, :], load))
        types = torch.where(sel[..., None], new_types, types2)
        bmask = torch.where(sel[..., None, None], nm[:, None], bmask2)
        bhas = torch.where(sel[..., None], nh[:, None], bhas2)
        btmpl = torch.where(sel, m_star[:, None].to(_I32), btmpl)
        btier = torch.where(sel, g_tier[g], btier)

        # ---- nodepool limits: subtract worst-case capacity per new bin ----
        n_opened = sel.to(_F32).sum(-1)  # [N]
        if fma_rem:
            rem = rem.scatter(1, star_idx, fma32(
                -worst, n_opened[:, None], rem_star)[:, None, :])
        else:
            rem = rem.scatter_add(1, star_idx,
                                  (-worst * n_opened[:, None])[:, None, :])

        # ---- conflict-class commit ----
        landed = (upd | (sel & (pods_new > 0)))[..., None]
        bdecl = torch.where(landed, bdecl | decl_g, bdecl)
        bmatch = torch.where(landed, bmatch | match_g, bmatch)
        # spread/affinity class counts grow by the bin's total take for
        # every class whose selector matches this group
        total_take = take + pods_new  # [N,B]
        bscnt = bscnt + total_take[..., None] * smatch_i
        baff = baff + total_take[..., None] * amatch_i
        assign[:, g] = total_take

    return dict(
        assign=assign,
        assign_e=assign_e,
        used=used,
        npods=npods,
        types=types,
        tmpl=btmpl,
        tier=btier,
    )


def _with_defaults(args: dict) -> dict:
    """``args`` with the absent tensor families filled in: no topology
    classes, no tiers, no minValues, and — when no existing-node tensors
    were given — one inert node (zero capacity) that phase A leaves out."""
    args = dict(args)
    dev = args["g_demand"].device
    G, R = args["g_demand"].shape

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    if "g_bin_cap" not in args:
        args["g_bin_cap"] = full((G,), 1 << 30, _I32)
    if "g_single" not in args:
        args["g_single"] = full((G,), False, torch.bool)
    if "g_decl" not in args:
        CW = args["g_match"].shape[1] if "g_match" in args else 1
        args["g_decl"] = full((G, CW), 0, _I32)
    if "g_match" not in args:
        args["g_match"] = full((G, args["g_decl"].shape[1]), 0, _I32)
    if "g_sown" not in args:
        C = args["g_smatch"].shape[1] if "g_smatch" in args else 1
        args["g_sown"] = full((G, C), UNCAPPED, _I32)
    if "g_smatch" not in args:
        args["g_smatch"] = full((G, args["g_sown"].shape[1]), False, torch.bool)
    if "g_aneed" not in args:
        A = args["g_amatch"].shape[1] if "g_amatch" in args else 1
        args["g_aneed"] = full((G, A), False, torch.bool)
    if "g_amatch" not in args:
        args["g_amatch"] = full((G, args["g_aneed"].shape[1]), False, torch.bool)
    if "g_tier" not in args:
        args["g_tier"] = full((G,), 0, _I32)
    C = args["g_sown"].shape[1]
    CW = args["g_decl"].shape[1]
    if "e_avail" not in args:
        args["e_avail"] = full((1, R), 0.0, _F32)
    E = args["e_avail"].shape[-2]
    if "ge_ok" not in args:
        args["ge_ok"] = full((G, E), False, torch.bool)
    if "e_npods" not in args:
        args["e_npods"] = full((E,), 0, _I32)
    if "e_scnt" not in args:
        args["e_scnt"] = full((E, C), 0, _I32)
    if "e_decl" not in args:
        args["e_decl"] = full((E, CW), 0, _I32)
    if "e_match" not in args:
        args["e_match"] = full((E, CW), 0, _I32)
    if "e_aff" not in args:
        args["e_aff"] = full((E, args["g_aneed"].shape[1]), 0, _I32)
    if "m_minv" not in args:
        args["m_minv"] = full((args["m_overhead"].shape[0],), 0, _I32)
    return args


def _feasibility(args):
    return feasibility(
        args["g_mask"], args["g_has"], args["g_demand"],
        args["t_mask"], args["t_has"], args["t_alloc"],
        args["g_zone_allowed"], args["g_ct_allowed"],
        args["off_zone"], args["off_ct"], args["off_avail"], args["off_price"],
        args["g_tmpl_ok"], args["m_mask"], args["m_has"],
        g_tol=args.get("g_tol"), t_tol=args.get("t_tol"),
        m_tol=args.get("m_tol"),
    )


def _pack(args, F, tmpl_full, g_count, e_avail, **kw):
    return pack(
        args["g_demand"], g_count, args["g_mask"], args["g_has"], F,
        tmpl_full, args["g_bin_cap"], args["g_single"], args["g_decl"],
        args["g_match"], args["g_sown"], args["g_smatch"], args["g_aneed"],
        args["g_amatch"], args["g_tier"],
        args["ge_ok"], e_avail, args["e_npods"], args["e_scnt"],
        args["e_decl"], args["e_match"], args["e_aff"],
        args["t_alloc"], args["t_cap"], args["t_tmpl"], args["m_mask"],
        args["m_has"], args["m_overhead"], args["m_limits"], args["m_minv"],
        **kw,
    )


def solve_step(args: dict, max_bins: int, with_existing: bool | None = None,
               level_bits: int = _LEVEL_SEARCH_ITERS,
               max_minv: int | None = None, fma_rem: bool = True) -> dict:
    """The full single-call solve over one snapshot's tensor dict (see
    ``from_kernel_args``): defaults for absent tensor families, then
    feasibility + pack (one row) on the tensors' device. Returns the pack
    dict plus ``F`` and ``price``. ``fma_rem=False`` is the rule of the
    reference's batched solve (module docstring)."""
    if max_minv is None:
        mv = args.get("m_minv")
        # graftlint: disable=GL101 -- the minValues width sizes the pack's
        # state: a host read of an input before any device work is queued
        # (every dispatch site passes max_minv)
        max_minv = int(mv.max()) if mv is not None and mv.numel() else 0
    if with_existing is None:
        with_existing = "e_avail" in args
    args = _with_defaults(args)
    F, price, tmpl_full = _feasibility(args)
    # the reference's solve contracts the capacity formula only when the
    # bin and type axes match (module docstring)
    out = _pack(args, F, tmpl_full, args["g_count"][None],
                args["e_avail"][None], max_bins=max_bins,
                with_existing=with_existing, level_bits=level_bits,
                max_minv=max_minv,
                fma_cap=max_bins == args["t_alloc"].shape[0],
                fma_rem=fma_rem)
    out = {k: v[0] for k, v in out.items()}
    out["F"] = F
    out["price"] = price
    return out


def probe_step(varying: dict, shared: dict, max_bins: int, max_minv: int,
               level_bits: int = _LEVEL_SEARCH_ITERS):
    """The consolidation probe over a chunk of counterfactual rows: the
    JAX package's vmapped ``solve_step`` (``_batched_kernel``'s ``probe``)
    with ``varying = {g_count [Np,Gp], e_avail [Np,Ep,R]}`` on the row
    axis and every other tensor in ``shared``. Feasibility runs once, the
    pack once for all rows. Returns ``(placed_g [Np,Gp], used [Np])``:
    per-row per-group placed pods (new bins and existing nodes) and
    per-row opened bins, as int32 tensors on the device."""
    args = _with_defaults({**shared, "e_avail": varying["e_avail"]})
    F, _, tmpl_full = _feasibility(args)
    out = _pack(args, F, tmpl_full, varying["g_count"], varying["e_avail"],
                max_bins=max_bins, with_existing=True, level_bits=level_bits,
                max_minv=max_minv, fma_cap=False, fma_rem=False)
    placed_g = out["assign"].sum(2, dtype=_I32) + out["assign_e"].sum(
        2, dtype=_I32)
    return placed_g, out["used"].sum(-1, dtype=_I32)
