"""Solver: the device/host boundary of the port.

``TorchSolver`` is the port of ``karpenter_tpu.models.solver.TPUSolver``
for an empty-cluster burst without topology: it compiles the snapshot to
tensors (``ops.tensorize``), runs feasibility + pack on the device
(``ops.kernels.solve_step``, whose requirement-compat products are the
CUDA kernel of ``ops.cuda_kernels``), reads the outputs back as ONE int32
buffer, and decodes bins into in-flight NodeClaims validated on the host.
Pods the device path cannot express, and leftovers, go through
``HostSolver`` — the FFD loop — seeded with the device-built claims, as in
the JAX package; that route is part of the semantics.

Stages covered, as in ``TPUSolver.solve``/``_run_and_decode``/``_unpack``/
``_decode``/``_compat_entry``/``_decomposable``: device eligibility,
tensorize, the bin-axis estimate and ``level_bits``, the doubling re-run
while bins run dry (a plain synchronous re-run), the single-buffer read
back and the host decode.

Not in this slice (see ROADMAP.md): existing nodes and topology (both
raise ``NotImplementedError``), the LP bin floor, the native C++ rung, the
small-batch host cutoff, the mesh, replay capsules and the decision
ledger.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.models.inflight import InFlightNodeClaim
from karpenter_tpu_torch.models.scheduler import (
    NullTopology,
    Scheduler,
    SchedulerResults,
    subtract_max,
)
from karpenter_tpu_torch.ops import kernels
from karpenter_tpu_torch.ops.tensorize import (
    _COMPAT_CACHE_MAX,
    STATS as _TZ_STATS,
    bucket as _bucket,
    device_eligible,
    kernel_args,
    tensorize,
)
from karpenter_tpu_torch.utils import resources as resutil


class Solver:
    def solve(self, pods, templates, instance_types, **kw) -> SchedulerResults:
        raise NotImplementedError


class HostSolver(Solver):
    """The reference algorithm (FFD loop) on the host."""

    def solve(self, pods, templates, instance_types, topology=None,
              existing_nodes=(), daemon_overhead=None, limits=None,
              initial_claims=()) -> SchedulerResults:
        sched = Scheduler(
            templates,
            instance_types,
            topology=topology,
            existing_nodes=existing_nodes,
            daemon_overhead=daemon_overhead,
            remaining_resources=limits,
        )
        sched.new_claims = list(initial_claims)
        return sched.solve(pods)


class TorchSolver(Solver):
    def __init__(self, device=None):
        """``device`` defaults to ``cuda`` and then raises when no CUDA
        device is present — the port never drops to the CPU on its own;
        pass ``device="cpu"`` for the plain PyTorch path."""
        if device is None and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSolver runs on CUDA and no CUDA device is present; "
                "pass device='cpu' to run the plain PyTorch path")
        self.device = torch.device("cuda" if device is None else device)
        self.host = HostSolver()
        self.last_device_stats: dict = {}

    def solve(self, pods, templates, instance_types, topology=None,
              existing_nodes=(), daemon_overhead=None, limits=None,
              max_bins: int | None = None) -> SchedulerResults:
        if topology is not None and not isinstance(topology, NullTopology):
            raise NotImplementedError(
                "TorchSolver: topology constraints are a later slice of the "
                "port (ROADMAP.md Queue 1, the topology path)")
        if existing_nodes:
            raise NotImplementedError(
                "TorchSolver: existing nodes are a later slice of the port "
                "(ROADMAP.md Queue 1, existing nodes)")
        if not templates:
            self.last_device_stats = dict(
                groups=0, types=0, device_pods=0, retry_pods=0,
                host_pods=len(pods), engine="host")
            return self.host.solve(pods, templates, instance_types,
                                   daemon_overhead=daemon_overhead,
                                   limits=limits)
        stages: dict = {}
        rows0 = (_TZ_STATS["group_row_hits"], _TZ_STATS["group_row_misses"])
        # weight order decides which template a new bin opens from
        templates = sorted(templates, key=lambda t: (-t.weight, t.nodepool_name))
        eligible, rest = [], []
        for p in pods:
            ok = p.__dict__.get("_elig_cache")
            if ok is None:
                ok = device_eligible(p)
                p.__dict__["_elig_cache"] = ok
            (eligible if ok else rest).append(p)
        if not eligible:
            self.last_device_stats = dict(
                groups=0, types=0, device_pods=0, retry_pods=0,
                host_pods=len(pods), engine="host")
            return self.host.solve(pods, templates, instance_types,
                                   daemon_overhead=daemon_overhead,
                                   limits=limits)
        t0 = time.perf_counter()
        snap = tensorize(eligible, templates, instance_types,
                         daemon_overhead=daemon_overhead, limits=limits)
        stages["tensorize_ms"] = (time.perf_counter() - t0) * 1000.0
        claims, retry = self._run_and_decode(snap, max_bins, stages)
        self.last_device_stats = dict(
            groups=snap.G,
            types=snap.T,
            device_pods=len(eligible) - len(retry),
            retry_pods=len(retry),
            host_pods=len(rest),
            engine=self.device.type,
            group_row_cache_hits=_TZ_STATS["group_row_hits"] - rows0[0],
            group_row_cache_misses=_TZ_STATS["group_row_misses"] - rows0[1],
            **stages,
        )
        # debit nodepool limits for the device-built claims so the host pass
        # can't double-spend them (scheduler.go:292 subtractMax)
        if limits:
            limits = {k: dict(v) for k, v in limits.items()}
            for claim in claims:
                pool = claim.template.nodepool_name
                if pool in limits:
                    limits[pool] = subtract_max(limits[pool], claim.instance_types)
        # leftovers + ineligible pods run through the host loop seeded with
        # the device-built claims (they can still land on those bins)
        if rest or retry:
            return self.host.solve(rest + retry, templates, instance_types,
                                   daemon_overhead=daemon_overhead,
                                   limits=limits, initial_claims=claims)
        for claim in claims:
            claim.finalize()
        return SchedulerResults(new_claims=claims, existing_nodes=[],
                                pod_errors={})

    @staticmethod
    def plan(snap, max_bins=None) -> dict:
        """The dispatch shape of a snapshot: bin axis ``B`` (from a
        per-resource demand lower bound with 1.5x FFD headroom, unless
        ``max_bins`` pins it), its bucket ``Bp``, the padded ``Gp``/``Tp``,
        ``level_bits`` and ``max_minv``."""
        G, T = snap.G, snap.T
        R = len(snap.resources)
        total_pods = int(snap.g_count.sum())
        if max_bins:
            B = max_bins
        else:
            demand_tot = (snap.g_demand * snap.g_count[:, None]).sum(axis=0)
            max_alloc = snap.t_alloc.max(axis=0) if T else np.ones(R, dtype=np.float32)
            with np.errstate(divide="ignore", invalid="ignore"):
                lb = np.where(max_alloc > 0, np.ceil(demand_tot / max_alloc), 0.0)
            est = int(np.nanmax(lb)) if lb.size else 1
            # topology caps (bin caps, anti/spread classes) are all inert in
            # this slice's snapshots; the cap lower bound reduces to this
            caps = np.maximum(snap.g_bin_cap.astype(np.int64), 1)
            cap_lb = int(np.ceil(snap.g_count / caps).max()) if G else 0
            est = max(est, min(cap_lb, total_pods))
            B = min(max(total_pods, 1), max((3 * est) // 2, 64), 4096)
        # the level-fill search range shrinks when every type caps its pod
        # count (kubelet max-pods): levels never exceed npods + take <= 2*cap
        level_bits = 20
        if resutil.PODS in snap.resources:
            pcap = float(snap.t_alloc[:, snap.resources.index(resutil.PODS)].max())
            if 0 < pcap < 1 << 18:
                level_bits = max(4, int(np.ceil(np.log2(2 * pcap + 4))))
        max_minv = int(snap.m_minv.max()) if snap.m_minv.size else 0
        return dict(B=B, Bp=_bucket(B), Gp=_bucket(G), Tp=_bucket(T),
                    level_bits=level_bits, max_minv=max_minv,
                    total_pods=total_pods)

    def _run_and_decode(self, snap, max_bins, stages):
        """Estimate the bin axis, dispatch, decode; while the estimated
        axis runs dry and pods are left over, re-run with a doubled axis
        (exact, just slower) rather than spill to the host loop. Gates on
        the kernel's own bin usage, not post-validation claim count."""
        G, T = snap.G, snap.T
        p = self.plan(snap, max_bins)
        B, Bp = p["B"], p["Bp"]
        args = kernels.from_kernel_args(
            kernel_args(snap, Gp=p["Gp"], Tp=p["Tp"]), self.device)
        compat_cache: dict = {}
        bin_cap = min(p["total_pods"], 4096)
        while True:
            t0 = time.perf_counter()
            host = self._invoke(args, Bp, p["level_bits"], p["max_minv"])
            stages["solve_ms"] = stages.get("solve_ms", 0.0) + (
                time.perf_counter() - t0) * 1000.0
            used = host["used"]
            grow = max_bins is None and bool(used[:B].all()) and B < bin_cap
            t0 = time.perf_counter()
            claims, retry = self._decode(
                snap, host["assign"][:G], used, host["F"][:G, :T],
                host["tmpl"], compat_cache)
            stages["decode_ms"] = stages.get("decode_ms", 0.0) + (
                time.perf_counter() - t0) * 1000.0
            if retry and grow:
                stages["bin_growths"] = stages.get("bin_growths", 0) + 1
                B = min(2 * B, 4096)
                Bp = _bucket(B)
                continue
            stages["bins"] = Bp
            return claims, retry

    def _invoke(self, args, max_bins, level_bits, max_minv):
        """One device dispatch: solve_step with every output flattened into
        ONE int32 buffer, read back to the host once."""
        out = kernels.solve_step(args, max_bins=max_bins, with_existing=False,
                                 level_bits=level_bits, max_minv=max_minv)
        flat = torch.cat([
            out["assign"].ravel(),
            out["assign_e"].ravel(),
            out["used"].to(torch.int32),
            out["tmpl"],
            out["F"].to(torch.int32).ravel(),
        ])
        return self._unpack(flat.cpu().numpy(), args, max_bins)

    @staticmethod
    def _unpack(flat, args, max_bins):
        """Split the single flattened int32 buffer back into the
        assign/assign_e/used/tmpl/F host dict."""
        G = args["g_mask"].shape[0]
        T = args["t_mask"].shape[0]
        B = max_bins
        E = args["e_avail"].shape[0] if "e_avail" in args else 1
        sizes = [G * B, G * E, B, B, G * T]
        offs = np.cumsum([0] + sizes)
        return {
            "assign": flat[offs[0] : offs[1]].reshape(G, B),
            "assign_e": flat[offs[1] : offs[2]].reshape(G, E),
            "used": flat[offs[2] : offs[3]].astype(bool),
            "tmpl": flat[offs[3] : offs[4]],
            "F": flat[offs[4] : offs[5]].reshape(G, T).astype(bool),
        }

    def _compat_entry(self, snap, feas, m, gset, template):
        """Distinct-(template, group-set) candidate types + precomputed fit
        thresholds. Candidate types: AND of the device's per-group
        feasibility rows — a sound PREFILTER, not the joint answer (F is
        pairwise, so it misses three-way value intersections and
        cross-offering splits). The host re-checks the MERGED requirement
        set on every survivor unless the set provably decomposes.

        Entries persist across solves in the type-side cache, keyed by
        (template index, per-group signature keys)."""
        persist = getattr(snap, "compat_cache", None)
        row_keys = getattr(snap, "row_keys", None)
        pkey = None
        if persist is not None and row_keys is not None:
            pkey = (m, tuple(row_keys[g] for g in gset))
            hit = persist.get(pkey)
            if hit is not None:
                return hit
        bin_reqs = template.requirements.copy()
        for g in gset:
            bin_reqs.add(*snap.group_reqs[g].values())
        joint = feas[gset[0]]
        for g in gset[1:]:
            joint = joint & feas[g]
        tsel = np.flatnonzero(joint & (snap.t_tmpl == m))
        # bins whose merged requirement set provably DECOMPOSES need no
        # merged re-check (see _decomposable)
        tmeta = getattr(snap, "_tmpl_keymeta", None)
        if tmeta is None:
            tmeta = [
                (
                    frozenset(tpl.requirements.keys()),
                    wk.TOPOLOGY_ZONE_LABEL not in tpl.requirements
                    and wk.CAPACITY_TYPE_LABEL not in tpl.requirements,
                )
                for tpl in snap.templates
            ]
            snap._tmpl_keymeta = tmeta
        tkeys, off_free = tmeta[m]
        exact = (
            off_free
            and all(tkeys.isdisjoint(snap.group_reqs[g].keys()) for g in gset)
            and (len(gset) == 1 or self._decomposable(snap, gset))
        )
        if exact and tsel.size:
            _TZ_STATS["decode_exact_skips"] += 1
        if tsel.size and not exact:
            mask_bin, has_bin, tol_bin = snap.mask_set(bin_reqs)
            tm, th, tt = snap.t_mask[tsel], snap.t_has[tsel], snap.t_tol[tsel]
            shared = th & has_bin[None, :]
            overlap = ((tm & mask_bin[None, :, :]) != 0).any(axis=2)
            # Intersects tolerates an empty meet iff BOTH operators are
            # NotIn/DoesNotExist (requirements.py:249)
            both_tol = tt & tol_bin[None, :]
            req_ok = (~shared | overlap | both_tol).all(axis=1)
            # offerings: available ∧ zone/capacity-type bit of the offering
            # inside the bin's merged allowed sets
            off_ok = snap.off_avail[tsel].copy()
            for label, off_idx in (
                (wk.TOPOLOGY_ZONE_LABEL, snap.off_zone[tsel]),
                (wk.CAPACITY_TYPE_LABEL, snap.off_ct[tsel]),
            ):
                k = snap.key_index.get(label)
                if k is None or not has_bin[k]:
                    continue
                nv = len(snap.vocab[label])
                if nv == 0:
                    continue
                bits = np.arange(nv)
                allowed = ((mask_bin[k, bits // 32] >> (bits % 32)) & 1).astype(bool)
                off_ok &= np.where(off_idx >= 0, allowed[np.maximum(off_idx, 0)], True)
            tsel = tsel[req_ok & off_ok.any(axis=1)]
        tobj = getattr(snap, "_type_obj_arr", None)
        if tobj is None:
            tobj = np.array([it for _, it in snap.type_refs], dtype=object)
            snap._type_obj_arr = tobj
        objs = list(tobj[tsel]) if tsel.size else []
        # allocatable/capacity rows with the fit tolerance pre-applied
        alloc = snap.alloc64()[tsel]
        alloc_thresh = alloc + resutil._EPS + resutil.FIT_REL_EPS * np.abs(alloc)
        tcap = snap.cap64()[tsel]
        entry = (bin_reqs, objs, alloc_thresh, tcap, tsel)
        if pkey is not None:
            if len(persist) >= _COMPAT_CACHE_MAX:
                persist.pop(next(iter(persist)))
            persist[pkey] = entry
        return entry

    @staticmethod
    def _decomposable(snap, gset) -> bool:
        """Multi-group arm of the decoder's exact-skip: True when the bin's
        merged requirement set decomposes per key into single-group checks
        F already made (keys carried by 2+ groups have bit-equal rows, and
        offering-constraining groups agree on zone and capacity type), so
        the merged re-check cannot remove a candidate."""
        has, mask, tol = snap.g_has, snap.g_mask, snap.g_tol
        carriers: list = [None] * has.shape[1]
        for g in gset:
            for k in np.flatnonzero(has[g]):
                first = carriers[k]
                if first is None:
                    carriers[k] = g
                elif (tol[g, k] != tol[first, k]
                      or (mask[g, k] != mask[first, k]).any()):
                    return False
        zk = snap.key_index.get(wk.TOPOLOGY_ZONE_LABEL)
        ck = snap.key_index.get(wk.CAPACITY_TYPE_LABEL)
        off_keys = [k for k in (zk, ck) if k is not None]
        if off_keys:
            offg = [g for g in gset if any(has[g, k] for k in off_keys)]
            g0 = offg[0] if offg else None
            for g in offg[1:]:
                for k in off_keys:
                    if has[g, k] != has[g0, k]:
                        return False
                    if has[g0, k] and (
                        tol[g, k] != tol[g0, k]
                        or (mask[g, k] != mask[g0, k]).any()
                    ):
                        return False
        return True

    def _decode(self, snap, assign, used, feas, tmpl, compat_cache):
        """Bins → InFlightNodeClaims, with host-side validation of each
        claim's joint instance-type set (the kernel approximates joint
        offering feasibility by intersecting per-group feasibility).
        ``compat_cache`` carries distinct-(template, group-set) entries
        across the doubled re-runs of one solve."""
        from karpenter_tpu_torch.cloudprovider.types import satisfies_min_values

        cursors = [0] * snap.G
        claims = []
        retry = []
        R = len(snap.resources)
        # per-pod demand in float64 from the source dicts — the f32 kernel
        # tensors are too coarse at memory-byte scale
        demand64 = np.array(
            [[d.get(r, 0.0) for r in snap.resources] for d in snap.group_demand],
            dtype=np.float64,
        ).reshape(snap.G, R)
        topology = NullTopology()
        # nodepool-limit accounting mirroring the kernel's: a bin's
        # candidate types are filtered to those whose worst-case capacity
        # fits the remaining limits at open time, and the surviving worst
        # case is debited
        rem_limits = snap.m_limits.astype(np.float64).copy()
        Bax = assign.shape[1]
        cols = np.flatnonzero(used[:Bax] & (assign.sum(axis=0) > 0))
        breq = assign[:, cols].T.astype(np.float64) @ demand64
        breq += snap.m_overhead.astype(np.float64)[tmpl[cols]]
        sub = assign[:, cols]
        nz_ci, nz_gi = np.nonzero(sub.T)  # (bin-column, group) pairs, ci-major
        counts_flat = sub.T[nz_ci, nz_gi]
        row_starts = np.searchsorted(nz_ci, np.arange(len(cols)))
        row_ends = np.append(row_starts[1:], len(nz_ci))
        tmpl_cols = tmpl[cols]
        overhead_dicts = [
            dict(zip(snap.resources, row.tolist())) for row in snap.m_overhead
        ]
        # pass 1: per-bin memberships + cache keys
        bin_keys = []
        bin_meta = []  # (m, bin_pods)
        key_rows: dict = {}  # key -> [ci...]
        for ci in range(len(cols)):
            m = int(tmpl_cols[ci])
            bin_pods = []
            gset = []
            for j in range(row_starts[ci], row_ends[ci]):
                g = int(nz_gi[j])
                c = int(counts_flat[j])
                gset.append(g)
                bin_pods.extend(snap.groups[g][cursors[g] : cursors[g] + c])
                cursors[g] += c
            key = (m, tuple(gset))
            bin_keys.append(key)
            bin_meta.append((m, bin_pods))
            key_rows.setdefault(key, []).append(ci)

        # pass 2: distinct-key candidate sets + batched resource fit;
        # nodepool limits keep the sequential per-bin path
        no_limits = not np.isfinite(snap.m_limits).any()
        fit_rows = [None] * len(cols)
        its_rows = [None] * len(cols)
        for key, rows in key_rows.items():
            m, gset = key[0], list(key[1])
            cached = compat_cache.get(key)
            if cached is None:
                cached = self._compat_entry(snap, feas, m, gset, snap.templates[m])
                compat_cache[key] = cached
            _, objs, alloc_thresh, _, _ = cached
            rb = breq[rows]
            if no_limits:
                if len(rows) == 1:
                    row = (rb[0] <= alloc_thresh).all(axis=1)
                    fit_rows[rows[0]] = row
                    its_rows[rows[0]] = (
                        objs if row.all() else [objs[i] for i in np.flatnonzero(row)]
                    )
                    continue
                # clone bins (same key, same totals) share their candidates
                ub, inv = np.unique(rb, axis=0, return_inverse=True)
                ufits = (ub[:, None, :] <= alloc_thresh[None, :, :]).all(axis=2)
                uits = [
                    objs if row.all() else [objs[i] for i in np.flatnonzero(row)]
                    for row in ufits
                ]
                for i, ci in enumerate(rows):
                    fit_rows[ci] = ufits[inv[i]]
                    its_rows[ci] = uits[inv[i]]
            else:
                fits = (rb[:, None, :] <= alloc_thresh[None, :, :]).all(axis=2)
                for i, ci in enumerate(rows):
                    fit_rows[ci] = fits[i]

        for ci in range(len(cols)):
            m, bin_pods = bin_meta[ci]
            template = snap.templates[m]
            requests = {
                r: float(v) for r, v in zip(snap.resources, breq[ci].tolist()) if v > 0
            }
            bin_reqs, objs, _alloc_thresh, tcap, _ = compat_cache[bin_keys[ci]]
            ok = fit_rows[ci]
            if no_limits:
                its = its_rows[ci]  # InFlightNodeClaim copies its input list
            else:
                ok = ok & (
                    tcap <= rem_limits[m] + resutil._EPS
                    + resutil.FIT_REL_EPS * np.abs(rem_limits[m])
                ).all(axis=1)
                its = [objs[i] for i in np.flatnonzero(ok)]
            claim = InFlightNodeClaim(
                template,
                topology,
                overhead_dicts[m],
                its,
                requirements=bin_reqs.copy(),
            )
            claim.pods = bin_pods
            claim.requests = requests
            remaining = claim.instance_types
            if remaining and claim.requirements.has_min_values():
                _, err = satisfies_min_values(remaining, claim.requirements)
                if err:
                    remaining = []
            if not remaining:
                retry.extend(bin_pods)
                continue
            claim.instance_types = remaining
            # debit only once the claim survives validation
            if not no_limits:
                rem_limits[m] -= tcap[ok].max(axis=0)
            claims.append(claim)
        # pods the kernel couldn't place (unsched counts are implied by the
        # unconsumed remainder of each group)
        for g in range(snap.G):
            retry.extend(snap.groups[g][cursors[g] :])
        return claims, retry
