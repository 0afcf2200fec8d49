"""Solver: the device/host boundary of the port.

``TorchSolver`` is the port of ``karpenter_tpu.models.solver.TPUSolver``
for one provisioning round: it compiles the snapshot to tensors
(``ops.tensorize``; with a topology, through the waves compiler
``ops.waves`` first), compiles the cluster's existing nodes into phase A's
pre-loaded bins (``tensorize_existing``), runs feasibility + pack on the
device (``ops.kernels.solve_step``, whose requirement-compat products are
the CUDA kernel of ``ops.cuda_kernels``), reads the outputs back as ONE
int32 buffer, and decodes bins into in-flight NodeClaims and existing-node
placements validated on the host. Pods the device path cannot express,
and leftovers, go through ``HostSolver`` — the FFD loop — seeded with the
device-built claims, the updated existing nodes and the topology, as in
the JAX package; that route is part of the semantics.

Stages covered, as in ``TPUSolver.solve``/``_run_and_decode``/``_unpack``/
``_decode``/``_compat_entry``/``_decomposable``: device eligibility, the
waves compile and its host-routed reasons, tensorize, the bin-axis
estimate (demand, topology-class and LP-floor lower bounds,
``ops/relax.py``) and ``level_bits``, the doubling re-run while bins run
dry (a plain synchronous re-run), the single-buffer read back, the host
decode, the existing-node and topology commits and the nodepool-limit
debit before the host pass.

Not in this slice (see ROADMAP.md): ``existing_base=`` (the disruption
snapshot) and ``tier_of=`` (the fused admission round), which raise
``NotImplementedError``; the native C++ rung, the small-batch host
cutoff, the mesh, replay capsules and the decision ledger.
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
from karpenter_tpu_torch.ops import kernels, waves
from karpenter_tpu_torch.ops.relax import lp_bin_floor
from karpenter_tpu_torch.ops.tensorize import (
    _COMPAT_CACHE_MAX,
    SPREAD_OWNED_MIN,
    STATS as _TZ_STATS,
    bucket as _bucket,
    device_basic_eligible,
    device_eligible,
    group_by_signature,
    kernel_args,
    tensorize,
    tensorize_existing,
)
from karpenter_tpu_torch.utils import resources as resutil


class Solver:
    def solve(self, pods, templates, instance_types, **kw) -> SchedulerResults:
        raise NotImplementedError


class HostSolver(Solver):
    """The reference algorithm (FFD loop) on the host."""

    def solve(self, pods, templates, instance_types, topology=None,
              existing_nodes=(), daemon_overhead=None, limits=None,
              initial_claims=(), volume_topology=None) -> SchedulerResults:
        sched = Scheduler(
            templates,
            instance_types,
            topology=topology,
            existing_nodes=existing_nodes,
            daemon_overhead=daemon_overhead,
            remaining_resources=limits,
            volume_topology=volume_topology,
        )
        sched.new_claims = list(initial_claims)
        return sched.solve(pods)


def _host_stats(pods, host_routed, **stages) -> dict:
    return dict(groups=0, types=0, device_pods=0, retry_pods=0,
                host_pods=len(pods), existing_pods=0, engine="host",
                host_routed=host_routed, **stages)


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
              max_bins: int | None = None, volume_topology=None,
              existing_base=None, tier_of=None) -> SchedulerResults:
        if existing_base is not None or tier_of is not None:
            raise NotImplementedError(
                "TorchSolver: existing_base= (the disruption snapshot) and "
                "tier_of= (the fused admission round) are later slices of "
                "the port (ROADMAP.md Queue 1)")
        has_topology = bool(getattr(
            topology, "has_groups",
            topology is not None and not isinstance(topology, NullTopology)))
        if not templates:
            self.last_device_stats = _host_stats(
                pods, {"no-templates": len(pods)} if pods else {})
            return self.host.solve(
                pods, templates, instance_types, topology=topology,
                existing_nodes=existing_nodes, daemon_overhead=daemon_overhead,
                limits=limits, volume_topology=volume_topology)
        existing_nodes = list(existing_nodes)
        stages: dict = {}
        rows0 = (_TZ_STATS["group_row_hits"], _TZ_STATS["group_row_misses"])
        # weight order decides which template a new bin opens from
        # (scheduler.go:267 tries templates in weight order)
        templates = sorted(templates, key=lambda t: (-t.weight, t.nodepool_name))

        if has_topology:
            # topology-constrained batch: the waves compiler turns the
            # self-selecting constraint shapes into zone-pinned subgroups /
            # per-bin caps; everything it can't express routes to the host
            basic, rest = [], []
            for p in pods:
                ok = p.__dict__.get("_basic_elig_cache")
                if ok is None:
                    ok = device_basic_eligible(p)
                    p.__dict__["_basic_elig_cache"] = ok
                (basic if ok else rest).append(p)
            host_routed = {"ineligible-spec": len(rest)} if rest else {}
            t0 = time.perf_counter()
            plan = waves.compile_topology(group_by_signature(basic), topology)
            stages["waves_compile_ms"] = (time.perf_counter() - t0) * 1000.0
            rest.extend(plan.host_pods)
            for reason, n in getattr(plan, "host_reasons", {}).items():
                host_routed[reason] = host_routed.get(reason, 0) + n
            device_groups = plan.device_groups
            if not device_groups:
                self.last_device_stats = _host_stats(pods, host_routed, **stages)
                return self.host.solve(
                    pods, templates, instance_types, topology=topology,
                    existing_nodes=existing_nodes,
                    daemon_overhead=daemon_overhead, limits=limits,
                    volume_topology=volume_topology)
            eligible = [p for dg in device_groups for p in dg.pods]
            t0 = time.perf_counter()
            snap = tensorize(None, templates, instance_types,
                             daemon_overhead=daemon_overhead, limits=limits,
                             device_plan=plan)
            stages["tensorize_ms"] = (time.perf_counter() - t0) * 1000.0
            device_plan = plan
        else:
            eligible, rest = [], []
            for p in pods:
                ok = p.__dict__.get("_elig_cache")
                if ok is None:
                    ok = device_eligible(p)
                    p.__dict__["_elig_cache"] = ok
                (eligible if ok else rest).append(p)
            host_routed = {"ineligible-spec": len(rest)} if rest else {}
            if not eligible:
                self.last_device_stats = _host_stats(pods, host_routed)
                return self.host.solve(
                    pods, templates, instance_types,
                    existing_nodes=existing_nodes,
                    daemon_overhead=daemon_overhead, limits=limits,
                    volume_topology=volume_topology)
            t0 = time.perf_counter()
            snap = tensorize(eligible, templates, instance_types,
                             daemon_overhead=daemon_overhead, limits=limits)
            stages["tensorize_ms"] = (time.perf_counter() - t0) * 1000.0
            device_plan = None
        esnap = None
        if existing_nodes:
            t0 = time.perf_counter()
            esnap = tensorize_existing(snap, existing_nodes, device_plan)
            stages["tensorize_ms"] += (time.perf_counter() - t0) * 1000.0
        claims, retry, ecommits = self._run_and_decode(
            snap, esnap, max_bins, stages)
        self.last_device_stats = dict(
            groups=snap.G,
            types=snap.T,
            existing=esnap.E if esnap is not None else 0,
            device_pods=len(eligible) - len(retry),
            retry_pods=len(retry),
            host_pods=len(rest),
            existing_pods=sum(len(e[1]) for e in ecommits),
            engine=self.device.type,
            host_routed=host_routed,
            group_row_cache_hits=_TZ_STATS["group_row_hits"] - rows0[0],
            group_row_cache_misses=_TZ_STATS["group_row_misses"] - rows0[1],
            **stages,
        )
        # commit device placements onto the existing nodes (deferred so a
        # doubled re-run cannot double-apply); the host pass then sees the
        # updated availability/requirements (existingnode.go Add:64)
        for node, node_pods, delta, merged, gcounts in ecommits:
            node.pods.extend(node_pods)
            node.requests = resutil.merge(node.requests, delta)
            node.requirements = merged
            if has_topology:
                for g, c in gcounts:
                    topology.record_many(snap.groups[g][0], merged, c)
        if has_topology:
            # commit the FINAL claim set into the host topology engine once
            # (a doubled re-run discards its predecessor's claims, so decode
            # itself must not record): register each claim hostname domain
            # (nodeclaim.go:49) and record every landed group with
            # multiplicity (topology.go Record:141), so the host pass and
            # later rounds see the device placements
            for claim in claims:
                claim.topology = topology
                topology.register(wk.HOSTNAME_LABEL, claim.hostname)
                for g, c in getattr(claim, "_gcounts", ()):
                    topology.record_many(snap.groups[g][0], claim.requirements, c)
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
            return self.host.solve(
                rest + retry, templates, instance_types,
                topology=topology if has_topology else None,
                existing_nodes=existing_nodes,
                daemon_overhead=daemon_overhead, limits=limits,
                initial_claims=claims, volume_topology=volume_topology)
        for claim in claims:
            claim.finalize()
        return SchedulerResults(new_claims=claims,
                                existing_nodes=existing_nodes, pod_errors={})

    def plan(self, snap, max_bins=None, esnap=None) -> dict:
        """The dispatch shape of a snapshot: bin axis ``B`` (from the
        per-resource demand lower bound, the topology caps' lower bounds
        and the LP floor, with 1.5x FFD headroom, unless ``max_bins`` pins
        it), its bucket ``Bp``, the padded ``Gp``/``Tp``/``Ep``,
        ``level_bits``, ``max_minv``, the demand ``floor`` and whether the
        LP floor raised it (``lp_led``)."""
        G, T = snap.G, snap.T
        R = len(snap.resources)
        total_pods = int(snap.g_count.sum())
        floor = None  # the demand lower bound
        lp_led = False  # the LP relaxation floor raised it
        if max_bins:
            B = max_bins
        else:
            demand_tot = (snap.g_demand * snap.g_count[:, None]).sum(axis=0)
            max_alloc = snap.t_alloc.max(axis=0) if T else np.ones(R, dtype=np.float32)
            with np.errstate(divide="ignore", invalid="ignore"):
                lb = np.where(max_alloc > 0, np.ceil(demand_tot / max_alloc), 0.0)
            est = int(np.nanmax(lb)) if lb.size else 1
            # bin-cap topology groups force distinct bins: a cap-c group of
            # n pods needs >= ceil(n/c) bins regardless of resource demand
            # (different capped groups may share bins, so max not sum)
            caps = np.maximum(snap.g_bin_cap.astype(np.int64), 1)
            cap_lb = int(np.ceil(snap.g_count / caps).max()) if G else 0
            # self-conflicting anti classes force one pod per bin ACROSS
            # groups (a decl∩match group conflicts with every other group
            # of its class): class c needs >= sum of those groups' counts
            both = snap.g_decl & snap.g_match  # [G,CW]
            if both.any():
                for w in range(both.shape[1]):
                    live = np.bitwise_or.reduce(both[:, w])
                    for bit in range(32):
                        if not (live >> bit) & 1:
                            continue
                        sel = ((both[:, w] >> bit) & 1).astype(bool)
                        cap_lb = max(cap_lb, int(snap.g_count[sel].sum()))
            # spread classes share the per-bin cap ACROSS groups: class c
            # needs >= ceil(sum of owner counts / cap) distinct bins
            owned = snap.g_sown < SPREAD_OWNED_MIN
            if owned.any():
                cnt = snap.g_count[:, None] * owned  # [G,C]
                cap_c = np.where(owned, snap.g_sown, 1).max(axis=0)  # [C]
                cls_lb = np.ceil(cnt.sum(axis=0) / np.maximum(cap_c, 1)).max()
                cap_lb = max(cap_lb, int(cls_lb))
            est = max(est, min(cap_lb, total_pods))
            # LP relaxation floor (ops/relax.py): a weak-duality certified
            # bin lower bound over the same demand/capacity/compat tensors,
            # valid whether or not the iteration converged
            lp = lp_bin_floor(snap, est, self.device)
            if lp > est:
                est, lp_led = lp, True
            floor = est
            # 1.5x FFD headroom: the doubling re-run catches a miss
            B = min(max(total_pods, 1), max((3 * est) // 2, 64), 4096)
        E = esnap.E if esnap is not None else 0
        # the level-fill search range shrinks when every type caps its pod
        # count (kubelet max-pods): levels never exceed npods + take <= 2*cap
        level_bits = 20
        if resutil.PODS in snap.resources:
            pods_idx = snap.resources.index(resutil.PODS)
            pcap = float(snap.t_alloc[:, pods_idx].max())
            # existing nodes may hold AND absorb more pods than this solve's
            # catalog caps: the search range must reach npods + remaining
            # pods capacity or the fill silently under-places on them
            if esnap is not None and esnap.e_npods.size:
                e_need = esnap.e_npods + esnap.e_avail[:, pods_idx]
                pcap = max(pcap, float(e_need.max()))
            if 0 < pcap < 1 << 18:
                level_bits = max(4, int(np.ceil(np.log2(2 * pcap + 4))))
        max_minv = int(snap.m_minv.max()) if snap.m_minv.size else 0
        return dict(B=B, Bp=_bucket(B), Gp=_bucket(G), Tp=_bucket(T),
                    E=E, Ep=_bucket(max(E, 1), lo=8),
                    level_bits=level_bits, max_minv=max_minv,
                    total_pods=total_pods, floor=floor, lp_led=lp_led)

    def _run_and_decode(self, snap, esnap, max_bins, stages):
        """Estimate the bin axis, dispatch, decode; while the estimated
        axis runs dry and pods are left over, re-run with a doubled axis
        (exact, just slower) rather than spill to the host loop. Gates on
        the kernel's own bin usage, not post-validation claim count."""
        G, T = snap.G, snap.T
        p = self.plan(snap, max_bins, esnap)
        B, Bp, E = p["B"], p["Bp"], p["E"]
        stages["lp_led"] = p["lp_led"]
        stages["floor"] = p["floor"]
        args = kernels.from_kernel_args(
            kernel_args(snap, esnap, Gp=p["Gp"], Tp=p["Tp"], Ep=p["Ep"]),
            self.device)
        compat_cache: dict = {}
        bin_cap = min(p["total_pods"], 4096)
        while True:
            t0 = time.perf_counter()
            host = self._invoke(args, Bp, p["level_bits"], p["max_minv"])
            stages["solve_ms"] = stages.get("solve_ms", 0.0) + (
                time.perf_counter() - t0) * 1000.0
            used = host["used"]
            grow = max_bins is None and bool(used[:B].all()) and B < bin_cap
            assign_e = host["assign_e"][:G, :E] if esnap is not None else None
            t0 = time.perf_counter()
            claims, retry, ecommits = self._decode(
                snap, esnap, host["assign"][:G], assign_e, used,
                host["F"][:G, :T], host["tmpl"], compat_cache)
            stages["decode_ms"] = stages.get("decode_ms", 0.0) + (
                time.perf_counter() - t0) * 1000.0
            if retry and grow:
                stages["bin_growths"] = stages.get("bin_growths", 0) + 1
                B = min(2 * B, 4096)
                Bp = _bucket(B)
                continue
            stages.update(bins=Bp, B=B, Gp=p["Gp"], Ep=p["Ep"])
            return claims, retry, ecommits

    def _invoke(self, args, max_bins, level_bits, max_minv):
        """One device dispatch: solve_step with every output flattened into
        ONE int32 buffer, read back to the host once."""
        out = kernels.solve_step(args, max_bins=max_bins,
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

    def _decode(self, snap, esnap, assign, assign_e, used, feas, tmpl,
                compat_cache):
        """Bins → InFlightNodeClaims, with host-side validation of each
        claim's joint instance-type set (the kernel approximates joint
        offering feasibility by intersecting per-group feasibility).
        Existing-node columns decode first (phase-A pods are the head of
        each group) into deferred commit entries — validation is exact
        host-side (requirement compat + float64 fit) and a failed node
        routes its pods to retry without mutating the ExistingNode.
        ``compat_cache`` carries distinct-(template, group-set) entries
        across the doubled re-runs of one solve."""
        from karpenter_tpu_torch.cloudprovider.types import satisfies_min_values

        cursors = [0] * snap.G
        claims = []
        retry = []
        ecommits = []
        R = len(snap.resources)
        # per-pod demand in float64 from the source dicts — the f32 kernel
        # tensors are too coarse at memory-byte scale; shared by the
        # existing-node and claim decodes
        demand64 = np.array(
            [[d.get(r, 0.0) for r in snap.resources] for d in snap.group_demand],
            dtype=np.float64,
        ).reshape(snap.G, R)
        if esnap is not None and assign_e is not None:
            for e in np.flatnonzero(assign_e.sum(axis=0) > 0):
                node = esnap.nodes[int(e)]
                counts = assign_e[:, e]
                gidx = np.flatnonzero(counts)
                merged = node.requirements.copy()
                node_pods = []
                gcounts = []
                ok = True
                for g in gidx:
                    reqs = snap.group_reqs[int(g)]
                    if merged.compatible(reqs) is not None:
                        ok = False
                        break
                    merged.add(*reqs.values())
                req_vec = counts[gidx].astype(np.float64) @ demand64[gidx]
                delta = {
                    r: float(v)
                    for r, v in zip(snap.resources, req_vec.tolist())
                    if v > 0
                }
                if ok:
                    total = resutil.merge(node.requests, delta)
                    ok = resutil.fits(total, node.cached_available)
                for g in gidx:
                    c = int(counts[g])
                    taken = snap.groups[int(g)][cursors[int(g)] : cursors[int(g)] + c]
                    cursors[int(g)] += c
                    if ok:
                        node_pods.extend(taken)
                        gcounts.append((int(g), c))
                    else:
                        retry.extend(taken)
                if ok:
                    ecommits.append((node, node_pods, delta, merged, gcounts))
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
        bin_meta = []  # (m, bin_pods, gcounts)
        key_rows: dict = {}  # key -> [ci...]
        for ci in range(len(cols)):
            m = int(tmpl_cols[ci])
            bin_pods = []
            gset = []
            gcounts = []
            for j in range(row_starts[ci], row_ends[ci]):
                g = int(nz_gi[j])
                c = int(counts_flat[j])
                gset.append(g)
                gcounts.append((g, c))
                bin_pods.extend(snap.groups[g][cursors[g] : cursors[g] + c])
                cursors[g] += c
            key = (m, tuple(gset))
            bin_keys.append(key)
            bin_meta.append((m, bin_pods, gcounts))
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
            m, bin_pods, gcounts = bin_meta[ci]
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
            claim._gcounts = gcounts  # for the solver's topology commit
            claims.append(claim)
        # pods the kernel couldn't place (unsched counts are implied by the
        # unconsumed remainder of each group)
        for g in range(snap.G):
            retry.extend(snap.groups[g][cursors[g] :])
        return claims, retry, ecommits
