"""The consolidation probe: counterfactual rows through the row-batched pack.

The port of ``karpenter_tpu/ops/consolidate.py``. A disruption round asks
"if these candidate nodes were gone, would their pods land on the
surviving nodes plus at most ``max_bins`` fresh claims?" for many
candidate sets at once. Every set is a counterfactual ROW over one shared
snapshot of the cluster; a row differs from the master only in

- ``g_count``: pending pods plus the reschedulable pods of the row's
  candidates, and
- ``e_avail``: the cluster's nodes with those candidates zeroed out,

so a batch is two stacked tensors over one shared snapshot. ``max_bins=1``
encodes the reference's m→1 replacement rule (consolidation.go:164).
Rows run through ``ops.kernels.probe_step`` on the solver's device in
chunks of ``PROBE_CHUNK_ROWS``: feasibility once per chunk, the pack loop
once per chunk over the group rows, each row's bins in the same compat
launch — no Python loop over rows.

Three entry points, as in the JAX package, each building a
``DisruptionSnapshot`` from a live cluster (``build_disruption_snapshot``):

- ``batched_feasible_prefix``: the largest k such that candidates[:k]
  consolidate (MultiNodeConsolidation's ladder as one dispatch);
- ``batched_single_feasible``: per-candidate feasibility
  (SingleNodeConsolidation's scan as one dispatch);
- ``joint_retirement_plan``: the global joint retirement over every
  candidate — the LP relax rung (``ops/relax.py joint_relax_plan``) first
  on settled snapshots, then the FFD prefix ladder, with host rounding
  and repair in exact float64 arithmetic.

Probe answers are seeds for the confirming simulation: anything the probe
cannot express (waves-inexpressible shapes, non-basic-eligible pods)
returns None, a decision, never a device or launch fault. The snapshot's
device is its provisioner's solver's (``TorchSolver.device``).

Knobs (``utils/envknobs.py``): ``KARPENTER_REPLACE_MAX_CLAIMS`` (fresh
claims a joint row may open, default 1), ``KARPENTER_GLOBAL_REPAIR_MAX``
(host repair budget, 64), ``KARPENTER_TIER_WEIGHT`` (priority discount of
the retirement credit, 0) and ``KARPENTER_GLOBAL_FORMULATE_LOOP`` (the
per-candidate loops as the oracle of the vectorised formulation).

Left out (later slices, ROADMAP.md Queue 1): the ``SnapshotCache``,
``DisruptionSnapshot.advance`` and the delta registry across rounds; the
native probe rung; replay capture; the per-generation dispatch log and
``JointSeed`` the disruption methods read.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from karpenter_tpu_torch.ops import kernels
from karpenter_tpu_torch.ops.tensorize import (
    ExistingSnapshot,
    device_basic_eligible,
    group_by_signature,
    interned_signature,
    kernel_args,
    tensorize,
    tensorize_existing,
)
from karpenter_tpu_torch.utils.envknobs import env_bool, env_float, env_int

# counterfactual rows per probe_step call (the JAX package's chunk)
PROBE_CHUNK_ROWS = 128


def _pow2(n: int, lo: int = 8) -> int:
    """Next power of two >= n (>= lo) — the probe's pad ladder."""
    return max(lo, 1 << math.ceil(math.log2(max(n, 1))))


def _formulate_loop() -> bool:
    """``KARPENTER_GLOBAL_FORMULATE_LOOP=1`` forces the per-candidate
    Python loops (``_contribs_loop``, ``_cheapest_cum_loop``) where the
    vectorised construction would otherwise run: the bit-exactness oracle
    of the gather."""
    return env_bool("KARPENTER_GLOBAL_FORMULATE_LOOP", False)


class DisruptionSnapshot:
    """One tensorized cluster view shared by a whole disruption round.

    Holds the solver inputs, the existing-node axis, the master snapshot
    over (pending pods + every probeable candidate's reschedulable pods),
    and the per-pod group index that lets each probe derive its
    counterfactual ``g_count`` rows without re-tensorizing. ``device`` is
    where the rows run: the provisioner's solver's device."""

    def __init__(self, generation, build_key, inputs, pending, enodes,
                 col_by_pid, unprobeable, plan, snap, esnap, gidx_of, base,
                 device, topology=None, daemons=(), deleting_pods=()):
        self.generation = generation
        self.build_key = set(build_key)  # build-candidate provider ids
        self.inputs = inputs  # (templates, its_by_pool, overhead, limits, domains)
        self.pending = pending
        self.enodes = esnap.nodes if esnap is not None else enodes
        self.col_by_pid = col_by_pid  # provider_id -> existing-node column
        self.unprobeable = unprobeable  # provider ids the probe cannot express
        self.plan = plan
        self.snap = snap
        self.esnap = esnap
        self.gidx_of = gidx_of  # pod uid -> group index
        self.base = base  # [G] i32: pending-pod counts (every counterfactual's floor)
        self.device = torch.device(device)
        self.topology = topology
        self.daemons = list(daemons)  # daemonset pod templates at build
        # reschedulable pods of deleting/marked nodes (pre-provision
        # targets, helpers.go:340)
        self.deleting_pods = list(deleting_pods)
        # scheduling signature -> group row, for mapping sub-solve groups
        # onto this axis
        self.sig_to_group = {}
        for g, pods_g in enumerate(snap.groups):
            p0 = pods_g[0]
            sig = p0.__dict__.get("_sig_cache")
            if sig is None and plan is None:
                sig = interned_signature(p0)
            if sig is not None:
                self.sig_to_group.setdefault(sig, g)
        self.base = self._with_deleting(self.base)
        self.max_minv = int(snap.m_minv.max()) if snap.m_minv.size else 0
        # cheapest AVAILABLE offering across the whole catalog: the lower
        # bound of any replacement claim's launch price (the probes' price
        # prefilter; compatibility can only raise the true price)
        avail_prices = snap.off_price[snap.off_avail]
        self.min_price = float(avail_prices.min()) if avail_prices.size else float("inf")
        self._shared = None
        self._dims = None
        self._claimable = None
        # per existing-node row, the reschedulable-pod contribution over
        # the group axis, built lazily and GATHERED by contribs_for
        self._contrib_rows = None  # [E, G] int32
        self._contrib_ok = None  # [E] bool: every pod of the row mapped
        self._contrib_built = None  # [E] bool: row computed
        self._type_prices = None

    def columns_for(self, candidates):
        """Existing-node columns for the queried candidates; None when any
        of them is invisible or inexpressible (caller stays sequential)."""
        cols = []
        for c in candidates:
            col = self.col_by_pid.get(c.provider_id)
            if col is None:
                return None
            cols.append(col)
        return cols

    def contribs_for(self, candidates, cols=None):
        """[N,G] per-candidate reschedulable-pod counts over the snapshot's
        group axis; None when a pod is missing from the snapshot. Gathers
        rows of the cached [E,G] contribution matrix; a candidate without
        a usable cached row falls back to ``_contribs_loop``, which
        ``KARPENTER_GLOBAL_FORMULATE_LOOP=1`` forces everywhere."""
        if _formulate_loop():
            return self._contribs_loop(candidates)
        if cols is None:
            cols = self.columns_for(candidates)
        if cols is None:
            return self._contribs_loop(candidates)
        rows = np.asarray(cols, dtype=np.intp)
        self._ensure_contrib_rows(rows)
        if not self._contrib_ok[rows].all():
            return self._contribs_loop(candidates)
        return self._contrib_rows[rows]

    def _contribs_loop(self, candidates):
        """The per-candidate Python loop — the gather's oracle."""
        G = self.snap.G
        contrib = np.zeros((len(candidates), G), dtype=np.int32)
        for j, c in enumerate(candidates):
            for p in c.reschedulable_pods:
                g = self.gidx_of.get(p.uid)
                if g is None:
                    return None
                contrib[j, g] += 1
        return contrib

    def _ensure_contrib_rows(self, rows):
        """Materialize the cached contribution rows the gather needs, each
        once, from the bundle's node snapshots."""
        E, G = self.esnap.E, self.snap.G
        if self._contrib_rows is None:
            self._contrib_rows = np.zeros((E, G), dtype=np.int32)
            self._contrib_ok = np.zeros(E, dtype=bool)
            self._contrib_built = np.zeros(E, dtype=bool)
        for r in np.unique(rows[~self._contrib_built[rows]]):
            self._build_contrib_row(int(r))

    def _build_contrib_row(self, r):
        row = self._contrib_rows[r]
        row[:] = 0
        ok = True
        for p in self.enodes[r].state_node.reschedulable_pods():
            g = self.gidx_of.get(p.uid)
            if g is None:
                ok = False  # unmapped pod: the loop oracle answers None
                break
            row[g] += 1
        self._contrib_ok[r] = ok
        self._contrib_built[r] = True

    def type_price_vectors(self):
        """``(p_cat, name_idx)``: cheapest AVAILABLE offering price per
        instance-type NAME over the snapshot's catalog, cached."""
        if self._type_prices is None:
            self._type_prices = _type_price_vectors(self.snap)
        return self._type_prices

    def claimable_groups(self):
        """[G] bool — groups a fresh claim could ever be opened for
        (template compat + requirement overlap + fit net of daemon
        overhead + an available admissible offering), or None when G×T is
        too large to prove cheaply."""
        if self._claimable is None:
            s = self.snap
            G, T = s.G, s.T
            if G == 0 or T == 0:
                self._claimable = np.zeros(G, dtype=bool)
            elif G * T > (1 << 18):
                return None  # too big to prove; callers hedge instead
            else:
                compat = _group_type_compat(s)  # [G,T]
                alloc_eff = s.t_alloc - s.m_overhead[s.t_tmpl]
                fit = (
                    s.g_demand[:, None, :] <= alloc_eff[None, :, :] + 1e-6
                ).all(-1)
                self._claimable = (compat & fit).any(1)
        return self._claimable

    def _with_deleting(self, base):
        """Pending baseline plus drain-in-flight pods: the real simulation
        pre-provisions deleting/marked nodes' pods (helpers.go:340). Pods
        whose signature maps to no group are not counted."""
        if self.plan is not None or not self.deleting_pods:
            return base
        base = base.copy()
        for p in self.deleting_pods:
            g = self.sig_to_group.get(interned_signature(p))
            if g is not None:
                base[g] += 1
        return base

    # -- simulation fast path (the confirming simulation's inputs) -------

    def sim_enodes(self, excluded):
        """Prototype ExistingNodes for a counterfactual excluding the given
        provider ids, row-ordered; None when an excluded candidate is
        unknown to this bundle."""
        row_of, live = self.esnap.row_of, self.esnap.live
        for pid in excluded:
            if pid not in row_of:
                return None
        return [
            en
            for r, en in enumerate(self.enodes)
            if live[r] and en.state_node.provider_id not in excluded
        ]

    def sim_deleting_pods(self, seen):
        """Reschedulable pods of deleting/marked nodes not already in the
        sim's pod set."""
        return [p for p in self.deleting_pods if p.uid not in seen]

    def derive_esnap(self, sim_snap, existing_nodes):
        """ExistingSnapshot for a sub-solve, derived from this bundle's
        rows instead of a re-tensorize; None when a node or group fails to
        map (the caller pays the full build)."""
        base_snap, base = self.snap, self.esnap
        if self.plan is not None:
            return None
        if (
            sim_snap.keys != base_snap.keys
            or sim_snap.resources != base_snap.resources
            or sim_snap.W != base_snap.W
            or sim_snap.vocab != base_snap.vocab
        ):
            return None
        rows = []
        for en in existing_nodes:
            r = base.row_of.get(en.state_node.provider_id)
            if r is None or not base.live[r]:
                return None
            rows.append(r)
        gsel = []
        for pods_g in sim_snap.groups:
            g = self.sig_to_group.get(interned_signature(pods_g[0]))
            if g is None:
                return None
            gsel.append(g)
        rows = np.asarray(rows, dtype=np.intp)
        gsel = np.asarray(gsel, dtype=np.intp)
        return ExistingSnapshot(
            nodes=list(existing_nodes),
            e_avail=base.e_avail[rows],
            ge_ok=base.ge_ok[np.ix_(gsel, rows)],
            e_npods=base.e_npods[rows],
            e_scnt=base.e_scnt[rows],
            e_decl=base.e_decl[rows],
            e_match=base.e_match[rows],
            e_aff=base.e_aff[rows],
        )

    def _shared_args(self):
        """The shared snapshot as tensors on the bundle's device, padded on
        the pure power-of-two ladder, and ``(Gp, Ep)``."""
        if self._shared is None:
            Gp = _pow2(self.snap.G)
            Ep = _pow2(self.esnap.E)
            Tp = _pow2(self.snap.T)
            self._shared = kernels.from_kernel_args(
                kernel_args(self.snap, self.esnap, Gp=Gp, Tp=Tp, Ep=Ep,
                            include_counts=False),
                self.device)
            self._dims = (Gp, Ep)
        return self._shared, self._dims

    def dispatch(self, g_count_k, e_zero_cols, max_bins=1):
        """Run the row-batched pack over the counterfactual rows on the
        bundle's device; returns (placed_g [rows, Gp], used [rows]) as
        int64 numpy. ``max_bins`` caps the fresh claims a row may open
        (1 is the reference's m→1 rule). ``e_zero_cols[i]`` holds the
        existing-node columns row i removes."""
        shared, (Gp, Ep) = self._shared_args()
        return dispatch_counterfactual_rows(
            shared, Gp, Ep, self.esnap.e_avail, self.max_minv,
            g_count_k, e_zero_cols, max_bins=max_bins)


def chunk_rows(e_master, g_count_k, e_zero_cols, e_free, lo, hi, Gp):
    """One chunk's varying tensors on ``e_master``'s device: ``g_count
    [Np,Gp]`` and ``e_avail [Np,Ep,R]``, the row axis padded on the pow-2
    ladder (``Np = _pow2(hi-lo, lo=4)``, padded rows count zero pods).
    Each row's ``e_avail`` is the master with the row's columns zeroed,
    then its ``e_free`` release ``(col, delta[R])`` added — built on the
    device from index lists, never as a host ``[rows, E, R]`` array."""
    dev = e_master.device
    Ep, R = e_master.shape
    n = hi - lo
    Np = _pow2(n, lo=4)
    e_chunk = torch.zeros((Np, Ep, R), dtype=torch.float32, device=dev)
    e_chunk[:n] = e_master
    ri, ci = [], []
    for i in range(n):
        cols = e_zero_cols[lo + i]
        if cols is not None and len(cols):
            cols = np.asarray(cols, dtype=np.int64).ravel()
            ri.append(np.full(cols.size, i, dtype=np.int64))
            ci.append(cols)
    if ri:
        e_chunk[torch.from_numpy(np.concatenate(ri)).to(dev),
                torch.from_numpy(np.concatenate(ci)).to(dev)] = 0.0
    if e_free is not None:
        fi, fc, fv = [], [], []
        for i in range(n):
            fr = e_free[lo + i]
            if fr is not None:
                fi.append(i)
                fc.append(int(fr[0]))
                fv.append(np.asarray(fr[1], dtype=np.float32))
        if fi:
            e_chunk.index_put_(
                (torch.tensor(fi, device=dev), torch.tensor(fc, device=dev)),
                torch.from_numpy(np.stack(fv)).to(dev), accumulate=True)
    g_count = np.zeros((Np, Gp), dtype=np.int32)
    part = np.asarray(g_count_k[lo:hi])
    g_count[:n, :part.shape[1]] = part
    return dict(g_count=torch.from_numpy(g_count).to(dev), e_avail=e_chunk)


def dispatch_counterfactual_rows(shared, Gp, Ep, e_avail, max_minv,
                                 g_count_k, e_zero_cols, e_free=None,
                                 max_bins=1):
    """The probe dispatch over explicit tensors: ``shared`` is the
    snapshot's ``kernel_args(..., include_counts=False)`` as tensors on
    the device the rows run on (``kernels.from_kernel_args``); ``e_avail``
    is the master ``[E,R]`` availability. Rows are chunked at
    ``PROBE_CHUNK_ROWS``, each chunk one ``probe_step`` and one host read.

    ``e_free`` (optional, len == rows) carries per-row capacity releases:
    ``None`` or ``(col, delta[R])`` meaning row i sees ``e_avail[col]``
    grown by ``delta``, applied after the zeroed columns. Returns
    ``(placed_g [rows, Gp], used [rows])`` as int64 numpy."""
    dev = shared["g_demand"].device
    e_master = torch.zeros((Ep, e_avail.shape[1]), dtype=torch.float32,
                           device=dev)
    e_master[:e_avail.shape[0]] = torch.as_tensor(
        np.asarray(e_avail, dtype=np.float32)).to(dev)
    rows = g_count_k.shape[0]
    placed_g = np.empty((rows, Gp), dtype=np.int64)
    used = np.empty(rows, dtype=np.int64)
    for lo in range(0, rows, PROBE_CHUNK_ROWS):
        hi = min(lo + PROBE_CHUNK_ROWS, rows)
        n = hi - lo
        varying = chunk_rows(e_master, g_count_k, e_zero_cols, e_free,
                             lo, hi, Gp)
        out_placed, out_used = kernels.probe_step(
            varying, shared, max_bins=max_bins, max_minv=max_minv)
        host = torch.cat([out_placed[:n].ravel(), out_used[:n]]).cpu().numpy()
        placed_g[lo:hi] = host[:n * Gp].reshape(n, Gp)
        used[lo:hi] = host[n * Gp:]
    return placed_g, used


def build_disruption_snapshot(provisioner, cluster, store, candidates):
    """Assemble the shared tensor bundle for one disruption round, on the
    provisioner's solver's device. Returns None when the device path
    cannot express the scenario at all (the probes then fall back to the
    sequential search)."""
    from karpenter_tpu_torch.utils import pod as pod_util

    generation = cluster.consolidation_state()
    pending = [p for p in store.list("pods") if pod_util.is_provisionable(p)]
    if any(not device_basic_eligible(p) for p in pending):
        return None  # every counterfactual row must hold the pending pods

    # candidates whose pods the kernel can't express are dropped from the
    # bundle (not fatal): queries naming them fall back to the sequential
    # search, everyone else still rides the shared snapshot
    probeable, unprobeable = [], set()
    for c in candidates:
        pods = list(c.reschedulable_pods)
        if any(not device_basic_eligible(p) for p in pods):
            unprobeable.add(c.provider_id)
        else:
            probeable.append((c, pods))
    all_pods = pending + [p for _, ps in probeable for p in ps]
    if not all_pods:
        return None

    templates, its_by_pool, overhead, limits, domains = provisioner.solver_inputs()
    if not templates:
        return None

    # counterfactual topology: all candidate pods excluded from the cluster
    # domain counts (helpers.go:51's excluded-pod stance, applied across
    # every counterfactual at once)
    from karpenter_tpu_torch.controllers.provisioning.provisioner import (
        ClusterStateView,
    )
    from karpenter_tpu_torch.models.topology import Topology
    from karpenter_tpu_torch.ops import waves

    view = ClusterStateView(cluster, store)
    topology = Topology(cluster=view, domains=domains, pods=all_pods)

    state_nodes = list(cluster.nodes())
    enodes = provisioner._existing_nodes(state_nodes, topology)
    by_pid = {e.state_node.provider_id: i for i, e in enumerate(enodes)}
    col_by_pid = {}
    for c, _ in probeable:
        i = by_pid.get(c.provider_id)
        if i is None:
            unprobeable.add(c.provider_id)  # invisible to the probe
        else:
            col_by_pid[c.provider_id] = i

    plan = None
    if topology.has_groups:
        plan = waves.compile_topology(group_by_signature(all_pods), topology)
        if plan.host_pods:
            return None  # waves-inexpressible shape: stay sequential

    snap = tensorize(
        all_pods if plan is None else None, templates, its_by_pool,
        daemon_overhead=overhead, limits=limits or None, device_plan=plan,
    )
    if snap.G == 0:
        return None
    esnap = tensorize_existing(snap, enodes, plan)

    gidx_of = {}
    for g, pods_g in enumerate(snap.groups):
        for p in pods_g:
            gidx_of[p.uid] = g
    # pending pods join every counterfactual row (they contend for capacity
    # exactly as in the real simulation), but feasibility is judged PER
    # GROUP against the candidates' contribution only
    base = np.zeros(snap.G, dtype=np.int32)
    for p in pending:
        base[gidx_of[p.uid]] += 1

    return DisruptionSnapshot(
        generation=generation,
        build_key=frozenset(c.provider_id for c in candidates),
        inputs=(templates, its_by_pool, overhead, limits, domains),
        pending=pending,
        enodes=enodes,
        col_by_pid=col_by_pid,
        unprobeable=unprobeable,
        plan=plan,
        snap=snap,
        esnap=esnap,
        gidx_of=gidx_of,
        base=base,
        device=provisioner.solver.device,
        topology=topology,
        daemons=[
            ds.template for ds in store.list("daemonsets")
            if ds.template is not None
        ],
        deleting_pods=[
            p
            for sn in state_nodes
            if sn.marked_for_deletion or sn.deleting()
            for p in sn.reschedulable_pods()
        ],
    )


def _bundle_for(provisioner, cluster, store, candidates, cache, registry,
                build_candidates):
    build = build_candidates if build_candidates else list(candidates)
    if cache is not None:
        return cache.get(provisioner, cluster, store, build, registry=registry)
    return build_disruption_snapshot(provisioner, cluster, store, build)


def batched_feasible_prefix(provisioner, cluster, store, candidates,
                            cache=None, registry=None, build_candidates=None):
    """Largest k such that candidates[:k] consolidate into the remaining
    cluster plus at most one fresh claim, decided in one dispatch over the
    whole prefix ladder (every prefix is a counterfactual row).

    Returns ``(k, definitive)`` — ``definitive`` says the ladder's misses
    may be trusted (plan-free bundles whose claim accounting mirrored the
    simulation) — or None when the probe cannot express the scenario."""
    bundle = _bundle_for(
        provisioner, cluster, store, candidates, cache, registry,
        build_candidates,
    )
    if bundle is None:
        return None
    cols = bundle.columns_for(candidates)
    if cols is None:
        return None
    contrib = bundle.contribs_for(candidates, cols=cols)
    if contrib is None:
        return None

    base = bundle.base
    N = len(candidates)
    G = bundle.snap.G
    cum = np.cumsum(contrib, axis=0)  # [N,G]: row k = prefix k+1's candidate pods
    g_count_k = base[None, :] + cum  # pending pods contend exactly as in the real sim
    col_arr = np.asarray(cols, dtype=np.intp)
    # row k removes candidates[:k+1] (views into one array, not copies)
    e_zero_cols = [col_arr[: k + 1] for k in range(N)]

    placed_g, used = bundle.dispatch(g_count_k, e_zero_cols)
    if bundle.plan is None:
        feasible, definitive = _prefix_criterion(
            bundle, candidates, cum, placed_g, used)
    else:
        # topology ladders stay a SEED: per-group "the candidates' pods
        # land" only
        feasible = (placed_g[:, :G] >= cum).all(axis=1)
        definitive = False
    ks = np.flatnonzero(feasible)
    k = 0 if ks.size == 0 else int(ks[-1]) + 1
    return k, definitive


def batched_single_feasible(provisioner, cluster, store, candidates,
                            cache=None, registry=None, build_candidates=None):
    """Per-candidate consolidation feasibility, every candidate one row of
    one dispatch: row c removes ONLY candidate c and asks whether its
    reschedulable pods land on the surviving nodes plus at most one fresh
    claim. Returns ``(mask, definitive)`` (misses are definitive for
    plan-free bundles) or None when the scenario is inexpressible."""
    bundle = _bundle_for(
        provisioner, cluster, store, candidates, cache, registry,
        build_candidates,
    )
    if bundle is None:
        return None
    cols = bundle.columns_for(candidates)
    if cols is None:
        return None
    contrib = bundle.contribs_for(candidates, cols=cols)
    if contrib is None:
        return None

    base = bundle.base
    N = len(candidates)
    g_count_k = base[None, :] + contrib  # [N,G]
    col_arr = np.asarray(cols, dtype=np.intp)
    # row c removes ONLY candidate c
    e_zero_cols = [col_arr[c : c + 1] for c in range(N)]

    placed_g, used = bundle.dispatch(g_count_k, e_zero_cols)
    mask = _single_criterion(bundle, candidates, contrib, placed_g, used)
    return mask, bundle.plan is None


def _single_criterion(bundle, candidates, contrib, placed_g, used):
    """The per-candidate feasibility criterion, shared by
    ``batched_single_feasible`` and the joint ladder's single rows:
    candidate c's pods all land iff every group places at least c's
    contribution; plan-free bundles also apply the price prefilter (a row
    that opens the fresh claim consolidates only if some available
    offering is strictly cheaper than the candidate, and an unpriceable
    candidate aborts the replace path)."""
    G = bundle.snap.G
    mask = (placed_g[:, :G] >= contrib).all(axis=1)
    if bundle.plan is None:
        prices = np.array(
            [getattr(c, "price", 0.0) for c in candidates], dtype=np.float64
        )
        mask = mask & (
            (used == 0) | ((prices > 0) & (bundle.min_price < prices))
        )
    return mask


def _prefix_criterion(bundle, candidates, cum, placed_g, used):
    """The plan-free prefix ladder's model of the host's whole decision,
    shared by ``batched_feasible_prefix`` and ``joint_retirement_plan``
    (the JAX package's docstring carries the full argument). Returns
    ``(feasible[N], definitive)``: (1) every pod the simulation would open
    a claim for — pending and drain pods of CLAIMABLE groups included —
    must place within the survivors plus the fresh bin(s); (2) a prefix
    that needs a fresh claim must pass the price ladder
    (``_prefix_price_ok``); with ``KARPENTER_REPLACE_MAX_CLAIMS`` > 1 a
    row opening u > 1 claims must beat its retirement credit with u
    claims of the cheapest offering."""
    base = bundle.base
    G = bundle.snap.G
    claimable = bundle.claimable_groups()
    if claimable is None:
        required = base[None, :] + cum
        base_exempt_ok = int(base.sum()) == 0
    else:
        required = cum + np.where(claimable[:G], base, 0)[None, :]
        base_exempt_ok = True
    feasible = (placed_g[:, :G] >= required).all(axis=1)
    prefix_known, claim_ok = _prefix_price_ok(bundle, candidates)
    feasible &= (used == 0) | (prefix_known & claim_ok)
    if _replace_max_claims() > 1:
        credit = _prefix_credit(candidates)
        min_p = float(getattr(bundle, "min_price", 0.0) or 0.0)
        feasible &= (used <= 1) | (
            (min_p > 0) & (used.astype(np.float64) * min_p < credit))
    return feasible, base_exempt_ok


def _prefix_credit(candidates) -> np.ndarray:
    """[N] f64 — cumulative retirement credit of each prefix: summed
    candidate prices, discounted by ``KARPENTER_TIER_WEIGHT x`` the
    displaced priority mass (w=0 leaves the raw price sum)."""
    prices = np.array(
        [getattr(c, "price", 0.0) for c in candidates], dtype=np.float64)
    w = _tier_weight()
    if w > 0.0:
        prices = prices - w * _tier_mass(candidates)
    return np.cumsum(prices)


def _prefix_price_ok(bundle, candidates):
    """The price half of the shared criterion — filterByPrice and the
    same-type anti-churn cap per prefix, shared by the FFD ladder and the
    LP relax rung. Returns ``(prefix_known[N], claim_ok[N])``: whether
    every price in the prefix is known, and whether some offering passes
    both price gates for that prefix."""
    N = len(candidates)
    prices = np.array(
        [getattr(c, "price", 0.0) for c in candidates], dtype=np.float64
    )
    prefix_known = np.logical_and.accumulate(prices > 0)
    prefix_price = np.cumsum(prices)
    w = _tier_weight()
    if w > 0.0:
        prefix_price = np.cumsum(prices - w * _tier_mass(candidates))
    tp = getattr(bundle, "type_price_vectors", None)
    p_cat, name_idx = (tp() if tp is not None
                       else _type_price_vectors(bundle.snap))
    if p_cat.size:
        j_arr = np.fromiter(
            (name_idx.get(
                getattr(getattr(c, "instance_type", None), "name", None),
                -1)
             for c in candidates),
            dtype=np.int64, count=N)
        if _formulate_loop():
            cheapest = _cheapest_cum_loop(prices, j_arr, len(p_cat))
        else:
            cheapest = _cheapest_cum_vec(prices, j_arr, len(p_cat))
        is_option = p_cat[None, :] < prefix_price[:, None]
        overlap = is_option & np.isfinite(cheapest)
        max_price = np.where(overlap, cheapest, np.inf).min(axis=1)
        claim_ok = (
            is_option & (p_cat[None, :] < max_price[:, None])
        ).any(axis=1)
    else:
        claim_ok = np.zeros(N, dtype=bool)
    return prefix_known, claim_ok


def _type_price_vectors(snap):
    """Cheapest available offering price per instance-type name."""
    p_by_name: dict = {}
    for t, (_, it) in enumerate(snap.type_refs):
        avail = snap.off_price[t][snap.off_avail[t]]
        if avail.size:
            p = float(avail.min())
            if p < p_by_name.get(it.name, np.inf):
                p_by_name[it.name] = p
    p_cat = (np.fromiter(p_by_name.values(), dtype=np.float64)
             if p_by_name else np.zeros(0, dtype=np.float64))
    return p_cat, {nm: j for j, nm in enumerate(p_by_name)}


def _cheapest_cum_loop(prices, j_arr, M):
    """Oracle: the per-candidate running-min loop over the prefix
    (cheapest already-seen candidate price per type)."""
    N = len(prices)
    cheapest = np.full((N, M), np.inf)
    cur = np.full(M, np.inf)
    for i in range(N):
        j = int(j_arr[i])
        if j >= 0 and prices[i] > 0:
            cur[j] = min(cur[j], prices[i])
        cheapest[i] = cur
    return cheapest


def _cheapest_cum_vec(prices, j_arr, M):
    """Vectorised ``_cheapest_cum_loop``: the same float64 min over the
    same values in the same prefix order, one ``np.minimum.accumulate``
    per present type."""
    N = len(prices)
    cheapest = np.full((N, M), np.inf)
    for j in np.unique(j_arr):
        if j < 0:
            continue
        col = np.where((j_arr == j) & (prices > 0), prices, np.inf)
        cheapest[:, int(j)] = np.minimum.accumulate(col)
    return cheapest


# ---------------------------------------------------------------------------
# global consolidation: ONE joint retirement over every candidate
# ---------------------------------------------------------------------------

# host rounding/repair drop budget: how many trailing candidates the
# integral pass may shed from the device ladder's selection
GLOBAL_REPAIR_MAX = 64

# per-process joint-solve accounting: the formulate/solve/round-repair
# split of the JAX package's perf row
GLOBAL_STATS = {
    "plans": 0,
    "rows": 0,
    "formulate_ms": 0.0,
    "solve_ms": 0.0,
    "round_repair_ms": 0.0,
    "relax_ms": 0.0,
    "repair_drops": 0,
}


def _replace_max_claims() -> int:
    """KARPENTER_REPLACE_MAX_CLAIMS (default 1): how many fresh claims a
    joint retirement row may open — the REPLACE generalization of the
    reference's m→1 rule."""
    return env_int("KARPENTER_REPLACE_MAX_CLAIMS", 1, minimum=1)


def _tier_weight() -> float:
    """KARPENTER_TIER_WEIGHT (default 0): discount each candidate's
    retirement credit by ``w x`` the priority mass its eviction
    displaces."""
    return env_float("KARPENTER_TIER_WEIGHT", 0.0)


def _tier_mass(candidates) -> np.ndarray:
    """[N] f64 — summed priority of each candidate's reschedulable pods."""
    return np.array(
        [sum((getattr(p, "priority", 0) or 0)
             for p in getattr(c, "reschedulable_pods", ()) or ())
         for c in candidates],
        dtype=np.float64)


def _global_repair_bound() -> int:
    return env_int("KARPENTER_GLOBAL_REPAIR_MAX", GLOBAL_REPAIR_MAX,
                   minimum=0)


class JointPlan:
    """One global-consolidation proposal: the retirement set (post
    rounding/repair), the integral displacement plan for it, and the
    decision/timing story. ``viable=False`` plans carry the fallback
    ``reason`` instead of a set. ``solver`` names the rung that chose the
    set (``relax`` or ``ladder``); ``relax_fallback`` marks a ladder round
    the relax rung first attempted and declined."""

    def __init__(self, candidates, selected_idx=(), delete_only=True,
                 definitive=False, displacement=(), overflow=None,
                 n_claims=1, k_device=0, dropped=0, timings=None,
                 viable=True, reason="ok", prefix_feasible=None,
                 single_mask=None, generation=None, transient=False,
                 solver="ladder", relax_fallback=False):
        self._candidates = list(candidates)
        self.selected_idx = list(selected_idx)
        self.delete_only = delete_only
        self.definitive = definitive
        # [(provider_id, group_index, pod_count)] — where each displaced
        # pod group lands among the survivors (exact-arithmetic integral)
        self.displacement = list(displacement)
        # {group_index: pod_count} headed for the fresh claim(s)
        self.overflow = dict(overflow or {})
        self.n_claims = n_claims
        self.k_device = k_device  # the device ladder's pre-repair k
        self.dropped = dropped  # candidates shed by the repair pass
        self.timings = dict(timings or {})
        self.viable = viable
        self.reason = reason
        self.prefix_feasible = prefix_feasible
        self.single_mask = single_mask
        self.generation = generation
        self.transient = transient
        self.solver = solver
        self.relax_fallback = relax_fallback

    @property
    def selected(self):
        return [self._candidates[i] for i in self.selected_idx]


def joint_retirement_plan(provisioner, cluster, store, candidates,
                          cache=None, registry=None, build_candidates=None,
                          want_singles=False):
    """The global consolidation solve: every prefix of the
    disruption-cost order is a counterfactual row of one dispatch, scored
    by the shared prefix criterion, and a host rounding/repair pass makes
    the winning row's displacement plan integral. ``want_singles`` asks
    the same dispatch to carry the per-candidate single rows too (always
    carried when the bundle is mid-transition).

    On settled snapshots the LP relax rung (``ops/relax.py
    joint_relax_plan``) runs first on the bundle's device; a shipped relax
    plan carries ``solver="relax"`` and every relax decline falls through
    to the ladder with ``relax_fallback`` marked. Returns None when the
    probe cannot express the scenario, else a ``JointPlan``; non-viable
    plans name their cause (``topology-plan``, ``non-definitive``,
    ``no-retirement``, ``repair-bound``)."""
    t0 = time.perf_counter()
    bundle = _bundle_for(
        provisioner, cluster, store, candidates, cache, registry,
        build_candidates,
    )
    if bundle is None:
        return None
    if bundle.plan is not None:
        # waves-compiled bundles make every counterfactual row approximate
        return JointPlan(candidates, viable=False, reason="topology-plan")
    cols = bundle.columns_for(candidates)
    if cols is None:
        return None
    contrib = bundle.contribs_for(candidates, cols=cols)
    if contrib is None:
        return None

    N = len(candidates)
    cum = np.cumsum(contrib, axis=0)  # [N,G]
    g_count_k = bundle.base[None, :] + cum
    col_arr = np.asarray(cols, dtype=np.intp)
    e_zero_cols = [col_arr[: k + 1] for k in range(N)]
    transient = bool(int(bundle.base.sum())) or bool(bundle.deleting_pods)

    # LP relax fast path: settled snapshots only; every non-ship outcome
    # falls through to the ladder below
    relax_fb = False
    if not transient and N >= 2:
        from karpenter_tpu_torch.ops import relax as _relax

        if _relax.relax_enabled(bundle.device):
            rt = {"formulate_ms": (time.perf_counter() - t0) * 1000.0}
            rplan, _cause = _relax.joint_relax_plan(
                bundle, candidates, col_arr, contrib, cum, rt,
                device=bundle.device)
            if rplan is not None:
                _account(rt, 0, 0)
                return rplan
            relax_fb = True

    singles = (want_singles or transient) and N >= 2
    if singles:
        # row 0 is prefix row 0 (remove only candidate 0), rows N.. are
        # candidates 1..N-1 removed alone
        g_single = bundle.base[None, :] + contrib
        g_count_k = np.concatenate([g_count_k, g_single[1:]], axis=0)
        e_zero_cols = e_zero_cols + [
            col_arr[c: c + 1] for c in range(1, N)]
    rows_total = g_count_k.shape[0]
    t1 = time.perf_counter()
    placed_g, used = bundle.dispatch(g_count_k, e_zero_cols,
                                     max_bins=_replace_max_claims())
    t2 = time.perf_counter()

    single_mask = None
    if singles:
        placed_single = np.concatenate(
            [placed_g[0:1], placed_g[N:]], axis=0)
        used_single = np.concatenate([used[0:1], used[N:]])
        single_mask = _single_criterion(
            bundle, candidates, contrib, placed_single, used_single)
        placed_g, used = placed_g[:N], used[:N]
    feasible, definitive = _prefix_criterion(
        bundle, candidates, cum, placed_g, used)
    ks = np.flatnonzero(feasible)
    k = 0 if ks.size == 0 else int(ks[-1]) + 1
    timings = {
        "formulate_ms": (t1 - t0) * 1000.0,
        "solve_ms": (t2 - t1) * 1000.0,
    }
    seed_kw = dict(prefix_feasible=feasible, single_mask=single_mask,
                   generation=bundle.generation, transient=transient,
                   relax_fallback=relax_fb)
    if not definitive:
        # a non-definitive ladder under-estimates k: the round goes to the
        # per-candidate ladder, whose gallop recovers
        _account(timings, rows_total, 0)
        return JointPlan(candidates, k_device=k, timings=timings,
                         viable=False, reason="non-definitive", **seed_kw)
    if k < 2:
        _account(timings, rows_total, 0)
        return JointPlan(candidates, definitive=definitive,
                         k_device=k, timings=timings, viable=False,
                         reason="no-retirement", **seed_kw)

    t3 = time.perf_counter()
    k_final, plan, dropped = _round_repair(
        bundle, col_arr, contrib, k, used, feasible)
    timings["round_repair_ms"] = (time.perf_counter() - t3) * 1000.0
    _account(timings, rows_total, dropped)
    if plan is None:
        return JointPlan(candidates, definitive=definitive, k_device=k,
                         dropped=dropped, timings=timings, viable=False,
                         reason="repair-bound", **seed_kw)
    placements, overflow, n_claims = plan
    return JointPlan(
        candidates,
        selected_idx=range(k_final),
        delete_only=not overflow,
        definitive=definitive,
        displacement=placements,
        overflow=overflow,
        n_claims=n_claims,
        k_device=k,
        dropped=dropped,
        timings=timings,
        **seed_kw,
    )


def _account(timings, rows, dropped):
    GLOBAL_STATS["plans"] += 1
    GLOBAL_STATS["rows"] += rows
    GLOBAL_STATS["repair_drops"] += dropped
    for key in ("formulate_ms", "solve_ms", "round_repair_ms",
                "relax_ms"):
        GLOBAL_STATS[key] += timings.get(key, 0.0)


def _round_repair(bundle, col_arr, contrib, k, used, feasible):
    """Host integral rounding of the ladder's selection: re-derive the
    winning prefix's displacement plan in exact float64 arithmetic over
    the survivors' residual capacity and, when the kernel's f32 fit
    over-estimated, shed TRAILING candidates down to the next prefix the
    ladder scored feasible, attempts bounded by
    ``KARPENTER_GLOBAL_REPAIR_MAX``. Returns ``(k_final, (placements,
    overflow, n_claims) | None, drops)``."""
    base = bundle.base
    G = bundle.snap.G
    claimable = bundle.claimable_groups()
    if claimable is not None:
        base_req = np.where(claimable[:G], base, 0)
    else:
        base_req = base
    live = np.asarray(bundle.esnap.live, dtype=bool)
    budget = _global_repair_bound()
    attempts = 0
    k_cur = k
    while k_cur >= 2:
        surv = live.copy()
        surv[col_arr[:k_cur]] = False
        required = contrib[:k_cur].sum(axis=0) + base_req
        plan = _greedy_displace(
            bundle, surv, required, allow_claim=bool(used[k_cur - 1] > 0),
            max_claims=_replace_max_claims())
        if plan is not None:
            return k_cur, plan, k - k_cur
        if attempts >= budget:
            return k_cur, None, k - k_cur
        attempts += 1
        ks = np.flatnonzero(feasible[:k_cur - 1])
        k_cur = int(ks[-1]) + 1 if ks.size else 0
    return k_cur, None, k - k_cur


def _greedy_displace(bundle, surv, required, allow_claim, max_claims=1):
    """Exact-arithmetic displacement plan for one retirement set: place
    each group's required pods into surviving nodes' residual capacity
    (ge_ok-compatible, biggest-demand groups first, fullest-fitting nodes
    first), route any remainder to at most ``max_claims`` fresh claims
    when the row allowed it. Returns ``(placements, overflow, n_claims)``
    or None when the set does not round integrally. Residual capacity +
    ``ge_ok`` is the complete constraint set: the joint path only reaches
    here on plan-free bundles."""
    snap, esnap = bundle.snap, bundle.esnap
    g_demand = np.asarray(snap.g_demand, dtype=np.float64)
    resid = np.maximum(np.asarray(esnap.e_avail, dtype=np.float64), 0.0)
    resid[~surv] = 0.0
    ge_ok = np.asarray(esnap.ge_ok, dtype=bool)
    placements: list = []
    overflow: dict = {}
    order = np.argsort(-g_demand.sum(axis=1), kind="stable")
    for g in order:
        n = int(required[g])
        if n <= 0:
            continue
        d = g_demand[g]
        pos = d > 0
        if not pos.any():
            continue  # zero-demand pods land anywhere; the sim agrees
        rows = np.flatnonzero(surv & ge_ok[g])
        if rows.size:
            cap = np.floor(
                (resid[np.ix_(rows, np.flatnonzero(pos))] / d[pos][None, :])
                .min(axis=1) + _REPAIR_EPS
            ).astype(np.int64)
            for j in np.argsort(-cap, kind="stable"):
                if n <= 0:
                    break
                take = min(n, int(cap[j]))
                if take <= 0:
                    break  # caps are sorted descending: the rest are 0 too
                e = int(rows[j])
                placements.append((esnap.nodes[e].state_node.provider_id,
                                   int(g), take))
                resid[e] -= take * d
                n -= take
        if n > 0:
            if not allow_claim:
                return None
            overflow[int(g)] = overflow.get(int(g), 0) + n
    if not overflow:
        return placements, overflow, 0
    if max_claims <= 1:
        if not _one_claim_fits(snap, overflow):
            return None
        return placements, overflow, 1
    split = _claims_fit(snap, overflow, max_claims)
    if split is None:
        return None
    return placements, overflow, len(split)


def _claims_fit(snap, overflow, max_claims):
    """Greedily split the overflow pods across at most ``max_claims``
    fresh single-template claims — groups biggest-demand first, first-fit
    over already-open claims (largest addable count by binary search), a
    fresh claim only when no open one takes a single pod. Returns the
    per-claim ``{group: count}`` dicts, or None."""
    claims: list = []
    order = sorted(overflow,
                   key=lambda g: -float(snap.g_demand[g].sum()))
    for g in order:
        n = int(overflow[g])
        while n > 0:
            placed = False
            for claim in claims:
                lo, hi, take = 1, n, 0
                while lo <= hi:
                    mid = (lo + hi) // 2
                    trial = dict(claim)
                    trial[g] = trial.get(g, 0) + mid
                    if _one_claim_fits(snap, trial):
                        take, lo = mid, mid + 1
                    else:
                        hi = mid - 1
                if take:
                    claim[g] = claim.get(g, 0) + take
                    n -= take
                    placed = True
                    break
            if placed:
                continue
            if len(claims) >= max_claims:
                return None
            lo, hi, take = 1, n, 0
            while lo <= hi:
                mid = (lo + hi) // 2
                if _one_claim_fits(snap, {g: mid}):
                    take, lo = mid, mid + 1
                else:
                    hi = mid - 1
            if take == 0:
                return None  # a pod no single fresh node can carry
            claims.append({g: take})
            n -= take
    return claims


_REPAIR_EPS = 1e-9


def _group_type_compat(snap, gsel=None):
    """[n,T] bool — template compat ∧ requirement overlap (with the
    Intersects tolerance rule) ∧ some offering admissible for the
    group's zone/capacity-type sets, availability included. Shared by
    ``claimable_groups``, ``_one_claim_fits`` and the LP rungs; the
    per-pod vs aggregate FIT check stays with each caller."""
    s = snap
    sel = slice(None) if gsel is None else gsel
    tmpl_ok = s.g_tmpl_ok[sel][:, s.t_tmpl]  # [n,T]
    shared = s.g_has[sel][:, None, :] & s.t_has[None, :, :]
    ov = ((s.g_mask[sel][:, None] & s.t_mask[None, :]) != 0).any(-1)
    both_tol = s.g_tol[sel][:, None, :] & s.t_tol[None, :, :]
    req_ok = (~shared | ov | both_tol).all(-1)  # [n,T]
    zo, co = s.off_zone, s.off_ct
    zok = np.where(
        zo[None, :, :] >= 0,
        s.g_zone_allowed[sel][:, np.maximum(zo, 0)], True)
    cok = np.where(
        co[None, :, :] >= 0,
        s.g_ct_allowed[sel][:, np.maximum(co, 0)], True)
    off_ok = (s.off_avail[None] & zok & cok).any(-1)  # [n,T]
    return tmpl_ok & req_ok & off_ok


def _one_claim_fits(snap, overflow) -> bool:
    """Whether SOME instance type can carry every overflow pod on one
    fresh node: the shared group×type compat mask, jointly over every
    overflow group, and the aggregate demand (net of daemon overhead)
    inside the type's allocatable."""
    gsel = np.fromiter(overflow.keys(), dtype=np.intp)
    counts = np.fromiter(overflow.values(), dtype=np.int64)
    if snap.T == 0:
        return False
    ok_t = _group_type_compat(snap, gsel).all(axis=0)  # [T]
    if not ok_t.any():
        return False
    demand = (counts[:, None] * snap.g_demand[gsel]).sum(axis=0)
    alloc_eff = snap.t_alloc - snap.m_overhead[snap.t_tmpl]
    fits = (demand[None, :] <= alloc_eff + 1e-6).all(-1)  # [T]
    return bool((ok_t & fits).any())
