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
(host repair budget, 64) and ``KARPENTER_TIER_WEIGHT`` (priority discount
of the retirement credit, 0).

Across rounds, ``SnapshotCache`` keeps one snapshot per cluster-state
generation for every probe and confirming simulation of a round, and
patches it to a later generation from the cluster's structured delta
journal (``DisruptionSnapshot.advance``) instead of rebuilding it;
``JointSeed`` re-keys the joint dispatch's answer for the per-candidate
probes of the same generation, and ``DISPATCHES_BY_GEN`` counts the probe
dispatches of each generation (the contract is at most one).

The native rung: under the probe's gate (``ops/engines.py``
``probe_native``: the solver's master switch and work floor, on the
snapshot's G×T), rows go to the native engine's batched
probe entry (``native.solve_probe_batch``) in chunks of
``NATIVE_PROBE_CHUNK_ROWS``, on the numpy snapshot, as in the JAX
package; a native failure is logged and the rows take the device.

Observability, at the JAX package's sites: ``snapshot.build`` and
``snapshot.advance`` spans (``cache``), ``probe.dispatch`` per dispatch,
``probe.kernel`` per chunk (``device``: the launch and the chunk's one
readback, so the span holds its device work) with the compile ledger's
``probe.kernel`` key and the ``probe.rows`` padding site,
``probe.native`` per native chunk, ``global.relax``/``global.dispatch``
in the joint plan, and ``SnapshotCache``'s ``snapshot.advance``
decisions with the ``snapshot-rebuild`` anomaly.

Replay capture (obs/capsule.py): every ``DisruptionSnapshot.dispatch``
records the numpy snapshot, the rows and the host outputs under its
``seam`` (``probe.dispatch``, ``global.dispatch`` from
``joint_retirement_plan``, ``interruption.dispatch`` from the drain), in
the JAX package's layout (``row_capture_inputs``).
"""

from __future__ import annotations

import logging
import math
import time
from collections import OrderedDict

import numpy as np
import torch

from karpenter_tpu_torch import native, obs
from karpenter_tpu_torch.obs import capsule, devplane
from karpenter_tpu_torch.ops import engines, kernels
from karpenter_tpu_torch.ops.tensorize import (
    ExistingSnapshot,
    device_basic_eligible,
    group_by_signature,
    interned_signature,
    kernel_args,
    pad_to as pad,
    tensorize,
    tensorize_existing,
)
from karpenter_tpu_torch.utils.envknobs import env_float, env_int

# counterfactual rows per probe_step call (the JAX package's chunk)
PROBE_CHUNK_ROWS = 128
# counterfactual rows per native probe call (the JAX package's): the
# engine builds feasibility once per chunk, and only the chunk's
# [rows, E, R] availability is materialized; rows are independent, so the
# chunk size never changes an answer
NATIVE_PROBE_CHUNK_ROWS = 1024


def _pow2(n: int, lo: int = 8) -> int:
    """Next power of two >= n (>= lo) — the probe's pad ladder."""
    return max(lo, 1 << math.ceil(math.log2(max(n, 1))))


# per-generation probe-dispatch accounting: the short-circuit contract is
# at most ONE batched probe dispatch per cluster-state generation — read
# through ``max_dispatches_per_generation``. Bounded LRU so a long-lived
# process never grows the log without limit.
_DISPATCH_GEN_CAP = 4096
DISPATCHES_BY_GEN: "OrderedDict[int, int]" = OrderedDict()


def note_probe_dispatch(generation) -> None:
    """One probe-dispatch invocation (prefix, single, or joint rows)
    against a bundle at ``generation`` — called by
    :meth:`DisruptionSnapshot.dispatch`, the one funnel every
    consolidation counterfactual batch runs through."""
    n = DISPATCHES_BY_GEN.pop(generation, 0)
    DISPATCHES_BY_GEN[generation] = n + 1
    while len(DISPATCHES_BY_GEN) > _DISPATCH_GEN_CAP:
        DISPATCHES_BY_GEN.popitem(last=False)


def reset_dispatch_log() -> None:
    DISPATCHES_BY_GEN.clear()


def max_dispatches_per_generation() -> int:
    return max(DISPATCHES_BY_GEN.values(), default=0)


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
        self._shared_np = None
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
        a usable cached row falls back to ``_contribs_loop``."""
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

    def _contrib_invalidate(self, pids):
        """Mark rows dirty after a delta advance: the next gather
        recomputes exactly these rows and keeps every other one."""
        if self._contrib_built is None:
            return
        E = self.esnap.E
        if len(self._contrib_built) < E:
            grow = E - len(self._contrib_built)
            self._contrib_rows = np.concatenate(
                [self._contrib_rows,
                 np.zeros((grow, self.snap.G), dtype=np.int32)])
            self._contrib_ok = np.concatenate(
                [self._contrib_ok, np.zeros(grow, dtype=bool)])
            self._contrib_built = np.concatenate(
                [self._contrib_built, np.zeros(grow, dtype=bool)])
        for pid in pids:
            r = self.esnap.row_of.get(pid)
            if r is not None:
                self._contrib_built[r] = False

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

    # -- delta maintenance (tensorize.py's existing-node delta contract) --

    def _make_enode(self, state_node, store):
        """One ExistingNode prototype from live state — the per-node body
        of provisioner._existing_nodes, for dirty/added rows."""
        from karpenter_tpu_torch.models.existing import ExistingNode
        from karpenter_tpu_torch.scheduling import (
            daemon_schedulable,
            label_requirements,
        )
        from karpenter_tpu_torch.utils import resources as resutil

        sn = state_node.snapshot()
        taints = sn.taints()
        node_reqs = label_requirements(sn.labels()) if self.daemons else None
        daemon_resources: dict = {}
        for p in self.daemons:
            if daemon_schedulable(p, taints, node_reqs):
                daemon_resources = resutil.merge(
                    daemon_resources, p.effective_requests())
        return ExistingNode(sn, self.topology, daemon_resources, kube=store)

    def advance(self, cluster, store, deltas, generation,
                registry=None) -> bool:
        """Patch this bundle to ``generation`` from the cluster's structured
        delta journal instead of rebuilding. Returns False when any delta
        is inexpressible — opaque entries, a pod whose signature matches no
        tensorized group, topology-compiled plans, nodepool limits (usage
        drifts with node churn), or a churn so large a rebuild is cheaper
        — and the caller re-tensorizes from scratch; ``advance_refusal``
        names the cause."""
        with obs.span("snapshot.advance", kind="cache",
                      deltas=len(deltas)) as sp:
            ok = self._advance(cluster, store, deltas, generation, registry)
            if sp is not None:
                sp.attrs["applied"] = ok
            return ok

    def _advance(self, cluster, store, deltas, generation, registry) -> bool:
        from karpenter_tpu_torch.utils import pod as pod_util

        self.advance_refusal = None
        if self.plan is not None or self.topology is None:
            self.advance_refusal = "plan"
            return False
        if self.inputs[3]:
            # nodepool limits are remaining = spec - usage: every node
            # add/delete moves usage, and the cached inputs would go stale
            self.advance_refusal = "limits"
            return False
        dirty_pids: set = set()
        pod_events = []
        for d in deltas:
            if d is None:
                self.advance_refusal = "opaque-entry"
                return False  # opaque: nodepool/daemonset/resync
            if d[0] == "node":
                dirty_pids.add(d[1])
            else:  # ("pod", pod, node_name | None, gone)
                pod_events.append(d)

        # pods first: register new/refreshed pods onto the group axis (so
        # contribs_for keeps working for rebound replicas) and attribute
        # their nodes as dirty
        for _, pod, node_name, gone in pod_events:
            if node_name:
                sn = cluster.node_by_name(node_name)
                if sn is not None:
                    dirty_pids.add(sn.provider_id)
                # a vanished node has its own ("node", pid) entry
            if gone:
                continue
            if not device_basic_eligible(pod):
                if not node_name:
                    self.advance_refusal = "ineligible-pending"
                    return False  # pending pods must stay expressible
                sn = cluster.node_by_name(node_name)
                if sn is not None:
                    # the candidate's pods left the device vocabulary:
                    # queries naming it fall back to the sequential scan,
                    # exactly like an unprobeable candidate at build
                    self.unprobeable.add(sn.provider_id)
                    self.col_by_pid.pop(sn.provider_id, None)
                continue
            g = self.sig_to_group.get(interned_signature(pod))
            if g is None:
                self.advance_refusal = "unseen-signature"
                return False  # unseen scheduling shape: new group/vocab
            self.gidx_of[pod.uid] = g

        # node rows: rebuild dirty, append new, mask gone/ineligible
        esnap = self.esnap
        removed, dirty_nodes, added_nodes, added_pids = [], [], [], []
        for pid in dirty_pids:
            sn = cluster.node_for(pid)
            eligible = sn is not None and not (
                sn.marked_for_deletion or sn.deleting())
            row = esnap.row_of.get(pid)
            if eligible:
                en = self._make_enode(sn, store)
                if row is None:
                    added_nodes.append(en)
                    added_pids.append(pid)
                else:
                    dirty_nodes.append(en)  # revives masked rows too
            else:
                if row is not None and esnap.live[row]:
                    removed.append(pid)
                self.col_by_pid.pop(pid, None)
        # removals are cheap in-place masks (no row rebuild, no splice),
        # so an eviction wave's drained nodes never count against the
        # delta budget — only rows that must actually re-tensorize do
        churn = len(dirty_nodes) + len(added_nodes)
        if churn > max(16, esnap.E // 2):
            self.advance_refusal = "churn"
            return False  # a wave: rebuilding also re-compacts the E axis
        t_delta = time.perf_counter()
        esnap.apply_delta(
            self.snap, dirty=dirty_nodes, removed=removed, added=added_nodes,
            registry=registry,
        )
        GLOBAL_STATS["tensorize_delta_ms"] += (
            time.perf_counter() - t_delta) * 1000.0
        # formulation rows ride the delta too: exactly the touched rows
        # recompute on next gather, every other row is reused verbatim
        self._contrib_invalidate(
            [en.state_node.provider_id for en in dirty_nodes]
            + added_pids + removed)
        for pid in added_pids:
            self.col_by_pid[pid] = esnap.row_of[pid]
            self.build_key.add(pid)
        for en in dirty_nodes:
            pid = en.state_node.provider_id
            if pid not in self.unprobeable:
                self.col_by_pid[pid] = esnap.row_of[pid]

        # pending baseline + pre-provision targets, from live state
        pending = [p for p in store.list("pods") if pod_util.is_provisionable(p)]
        base = np.zeros(self.snap.G, dtype=np.int32)
        for p in pending:
            g = self.gidx_of.get(p.uid)
            if g is None:
                self.advance_refusal = "unseen-pending"
                return False  # a pod the journal never surfaced
            base[g] += 1
        self.pending = pending
        self.deleting_pods = [
            p
            for sn in cluster.state_nodes()
            if sn.marked_for_deletion or sn.deleting()
            for p in sn.reschedulable_pods()
        ]
        self.base = self._with_deleting(base)
        self.generation = generation
        # the padded-arg caches carry esnap rows
        self._shared = self._shared_np = None
        return True

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

    def _shared_host(self):
        """The shared snapshot as the numpy ``kernel_args(...,
        include_counts=False)``, padded on the pure power-of-two ladder,
        and ``(Gp, Ep)``."""
        if self._shared_np is None:
            Gp = _pow2(self.snap.G)
            Ep = _pow2(self.esnap.E)
            Tp = _pow2(self.snap.T)
            self._shared_np = kernel_args(self.snap, self.esnap, Gp=Gp, Tp=Tp,
                                          Ep=Ep, include_counts=False)
            self._dims = (Gp, Ep)
        return self._shared_np, self._dims

    def _shared_args(self):
        """The shared snapshot as tensors on the bundle's device, and
        ``(Gp, Ep)``."""
        if self._shared is None:
            shared_np, _ = self._shared_host()
            self._shared = kernels.from_kernel_args(shared_np, self.device)
        return self._shared, self._dims

    def dispatch(self, g_count_k, e_zero_cols, seam="probe.dispatch",
                 max_bins=1):
        """Run the row-batched pack over the counterfactual rows; returns
        (placed_g [rows, Gp], used [rows]) as int64 numpy. ``max_bins``
        caps the fresh claims a row may open (1 is the reference's m→1
        rule). ``e_zero_cols[i]`` holds the existing-node columns row i
        removes. A snapshot under the solver's work floor runs on the
        native engine (``engines.probe_native``), the rest on the bundle's
        device. ``seam`` names the replay-capture seam the dispatch
        records under: ``probe.dispatch`` for the per-candidate probes,
        ``global.dispatch`` for the joint ladder, ``interruption.dispatch``
        for the drain's absorb probe — one tensor layout, so each replays
        through the same chunked code."""
        # per-generation invocation accounting: the short-circuit contract
        # (one probe dispatch per generation) is read off this log
        note_probe_dispatch(self.generation)
        rows = g_count_k.shape[0]
        shared_np, (Gp, Ep) = self._shared_host()
        if engines.probe_native(self.snap.G, self.snap.T):
            try:
                with obs.span("probe.dispatch", rows=rows, engine="native"):
                    placed_g, used = dispatch_counterfactual_rows_native(
                        shared_np, Gp, Ep, self.esnap.e_avail, self.max_minv,
                        g_count_k, e_zero_cols, max_bins=max_bins)
            except (RuntimeError, ValueError):
                logging.getLogger(__name__).warning(
                    "native probe dispatch failed; using the device kernel",
                    exc_info=True)
            else:
                self._capture(seam, shared_np, Gp, Ep, g_count_k,
                              e_zero_cols, placed_g, used, "native",
                              max_bins)
                return placed_g, used
        shared, _ = self._shared_args()
        with obs.span("probe.dispatch", rows=rows, engine="device"):
            placed_g, used = dispatch_counterfactual_rows(
                shared, Gp, Ep, self.esnap.e_avail, self.max_minv,
                g_count_k, e_zero_cols, max_bins=max_bins)
        self._capture(seam, shared_np, Gp, Ep, g_count_k, e_zero_cols,
                      placed_g, used, "device", max_bins)
        return placed_g, used

    def _capture(self, seam, shared_np, Gp, Ep, g_count_k, e_zero_cols,
                 placed_g, used, engine, max_bins):
        """Replay capture of this dispatch (obs/capsule.py): the numpy
        snapshot by reference plus the rows (``row_capture_inputs``) and
        the host outputs, with the JAX package's static fields and the
        rows' ``max_bins``."""
        if not capsule.capture_enabled():
            return
        capsule.record_capture(
            seam, row_capture_inputs(shared_np, g_count_k, self.esnap.e_avail,
                                     e_zero_cols),
            {"placed_g": placed_g, "used": used},
            engine=engine, max_minv=self.max_minv, Gp=Gp, Ep=Ep,
            max_bins=max_bins)


def row_capture_inputs(shared_np, g_count_k, e_avail, e_zero_cols,
                       e_free=None) -> dict:
    """The replay-capture inputs of one counterfactual-row dispatch
    (obs/capsule.py, the JAX package's layout): the shared numpy snapshot
    plus the ``cf//`` sidecars — the rows' group counts, the master
    ``e_avail``, the zeroed columns flattened (``e_zero_idx``, with
    ``e_zero_len`` -1 for a None row) and, for the preemption probes, the
    per-row releases (``e_free_col``, -1 for None, and ``e_free_delta``)."""
    cf = capsule.CF_PREFIX
    lens = np.array([-1 if c is None else len(c) for c in e_zero_cols],
                    dtype=np.int64)
    parts = [np.asarray(c, dtype=np.int64).ravel()
             for c in e_zero_cols if c is not None and len(c)]
    inputs = dict(shared_np)
    inputs[cf + "g_count_rows"] = np.asarray(g_count_k)
    inputs[cf + "e_avail"] = np.asarray(e_avail)
    inputs[cf + "e_zero_idx"] = (np.concatenate(parts) if parts
                                 else np.zeros(0, dtype=np.int64))
    inputs[cf + "e_zero_len"] = lens
    if e_free is not None:
        R = np.asarray(e_avail).shape[1]
        cols = np.full(len(e_free), -1, dtype=np.int64)
        deltas = np.zeros((len(e_free), R), dtype=np.float32)
        for i, fr in enumerate(e_free):
            if fr is not None:
                cols[i] = int(fr[0])
                deltas[i] = np.asarray(fr[1], dtype=np.float32)
        inputs[cf + "e_free_col"] = cols
        inputs[cf + "e_free_delta"] = deltas
    return inputs


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
        Np = varying["g_count"].shape[0]
        # pow-2 row-ladder waste of this chunk (real counterfactual rows
        # vs the padded row axis the pack loop carries)
        devplane.record_padding("probe.rows", n, Np)
        # launch + host read in one device-kind leaf: the readback is
        # the chunk's one synchronisation, so the span holds its device
        # work
        with obs.span("probe.kernel", kind="device", rows=n):
            t0 = time.perf_counter()
            out_placed, out_used = kernels.probe_step(
                varying, shared, max_bins=max_bins, max_minv=max_minv)
            # the JAX package's key: the row axis, the snapshot shapes,
            # R and the static parameters; a first sight's seconds are
            # the launch (CUDA's first use, the compat build)
            devplane.record_dispatch(
                "probe.kernel",
                (Np, tuple(shared["g_mask"].shape),
                 tuple(shared["t_mask"].shape), Ep, e_avail.shape[1],
                 max_minv, max_bins),
                time.perf_counter() - t0)
            host = torch.cat(
                [out_placed[:n].ravel(), out_used[:n]]).cpu().numpy()
        placed_g[lo:hi] = host[:n * Gp].reshape(n, Gp)
        used[lo:hi] = host[n * Gp:]
    return placed_g, used


def dispatch_counterfactual_rows_native(shared, Gp, Ep, e_avail, max_minv,
                                        g_count_k, e_zero_cols, e_free=None,
                                        max_bins=1):
    """The native-engine half of :func:`dispatch_counterfactual_rows` over
    the numpy ``shared`` snapshot: chunks of ``NATIVE_PROBE_CHUNK_ROWS``,
    each row's ``e_avail`` the master with its columns zeroed, then its
    ``e_free`` release added, one ``native.solve_probe_batch`` per chunk.
    ``max_minv`` rides for symmetry (the engine reads ``m_minv`` from the
    arguments). Returns ``(placed_g [rows, Gp], used [rows])`` as int64
    numpy."""
    R = e_avail.shape[1]
    rows = g_count_k.shape[0]
    placed_g = np.empty((rows, Gp), dtype=np.int64)
    used = np.empty(rows, dtype=np.int64)
    for lo in range(0, rows, NATIVE_PROBE_CHUNK_ROWS):
        hi = min(lo + NATIVE_PROBE_CHUNK_ROWS, rows)
        n = hi - lo
        e_chunk = np.repeat(e_avail[None, :, :], n, axis=0)
        for i in range(n):
            cols = e_zero_cols[lo + i]
            if cols is not None and len(cols):
                e_chunk[i, cols, :] = 0.0
            fr = e_free[lo + i] if e_free is not None else None
            if fr is not None:
                e_chunk[i, int(fr[0]), :] += np.asarray(
                    fr[1], dtype=e_chunk.dtype)
        with obs.span("probe.native", kind="device", rows=n):
            pg, u = native.solve_probe_batch(
                shared,
                pad(np.asarray(g_count_k[lo:hi], dtype=np.int32), (n, Gp)),
                pad(e_chunk.astype(np.float32, copy=False), (n, Ep, R)),
                max_bins,
            )
        placed_g[lo:hi] = pg
        used[lo:hi] = u
    return placed_g, used


def build_disruption_snapshot(provisioner, cluster, store, candidates):
    """Assemble the shared tensor bundle for one disruption round, on the
    provisioner's solver's device. Returns None when the device path
    cannot express the scenario at all (the probes then fall back to the
    sequential search)."""
    with obs.span("snapshot.build", kind="cache",
                  candidates=len(candidates)):
        return _build_disruption_snapshot(
            provisioner, cluster, store, candidates)


def _build_disruption_snapshot(provisioner, cluster, store, candidates):
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
    esnap = tensorize_existing(
        snap, enodes, plan, registry=getattr(provisioner, "registry", None))

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


class SnapshotCache:
    """Round-scoped memo of the latest :class:`DisruptionSnapshot`, keyed
    on the cluster-state generation. One instance lives on the disruption
    controller's context so Emptiness → Global → MultiNode → SingleNode →
    validation share one tensorization per generation, and a later
    generation is reached by a delta advance where the journal allows.
    Every stale-bundle resolution records one ``snapshot.advance``
    decision (``delta``, or ``rebuild`` with the refusal's cause), and a
    held bundle displaced by a full rebuild marks the round with the
    ``snapshot-rebuild`` anomaly, as in the JAX package."""

    def __init__(self):
        self._bundle = None
        self._neg = None  # (generation, build_key) of a failed build
        self._last_refusal = None  # why the last delta-advance declined

    def get(self, provisioner, cluster, store, candidates, registry=None):
        from karpenter_tpu_torch.operator import metrics as m

        generation = cluster.consolidation_state()
        key = frozenset(c.provider_id for c in candidates)
        b = self._bundle
        advanced = None
        if b is not None and b.generation == generation and key <= b.build_key:
            if registry is not None:
                registry.counter(
                    m.DISRUPTION_SNAPSHOT_CACHE_HITS,
                    "disruption probes served from the snapshot cache",
                ).inc(kind="snapshot")
            return b
        if b is not None and b.generation < generation:
            # incremental maintenance: patch the bundle from the cluster's
            # structured delta journal instead of re-tensorizing the fleet;
            # anything the journal can't express falls through to the
            # full rebuild below
            b2 = advanced = self._try_advance(cluster, store, generation,
                                             registry)
            if b2 is not None and key <= b2.build_key:
                from karpenter_tpu_torch.obs import decisions

                decisions.record_decision("snapshot.advance", "delta",
                                          registry=registry)
                return b2
        if self._neg == (generation, key):
            # an inexpressible build is generation-stable: don't re-pay the
            # assembly for every method in the round
            if registry is not None:
                registry.counter(
                    m.DISRUPTION_SNAPSHOT_CACHE_HITS,
                    "disruption probes served from the snapshot cache",
                ).inc(kind="negative")
            return None
        if registry is not None:
            registry.counter(
                m.DISRUPTION_SNAPSHOT_CACHE_MISSES,
                "disruption snapshot rebuilds (generation bump or wider "
                "candidate set)",
            ).inc()
        if self._bundle is not None:
            # anomaly trigger: a held bundle is being displaced by a full
            # tensorization — the delta layer declined or the candidate key
            # widened; the first-ever build of a process is NOT an anomaly
            # (there was nothing to advance). The decision ledger records
            # the transition with the inexpressible-delta cause.
            from karpenter_tpu_torch.obs import decisions

            b_old = self._bundle
            if b_old.generation >= generation or advanced is not None:
                # same-generation (or already-advanced) displacement: only
                # a wider candidate key forces the rebuild
                reason = "candidate-widened"
            else:
                reason = self._last_refusal or "journal-gap"
            decisions.record_decision("snapshot.advance", "rebuild", reason,
                                      registry=registry)
            obs.anomaly("snapshot-rebuild", registry=registry,
                        generation=generation)
        b = build_disruption_snapshot(provisioner, cluster, store, candidates)
        if b is not None:
            self._bundle = b
            self._neg = None
        else:
            self._neg = (generation, key)
        return b

    def current(self, cluster):
        """The cached bundle when still generation-current, else None —
        the gate every simulation fast-path consumer must pass: a bundle
        whose generation matches the cluster's is a faithful mirror of
        live state (every informer mutation bumps the counter)."""
        b = self._bundle
        if (
            b is not None
            and cluster is not None
            and b.generation == cluster.consolidation_state()
        ):
            return b
        return None

    def refresh(self, provisioner, cluster, store, registry=None):
        """``current``, but a stale bundle first gets one delta-advance
        attempt — NEVER a rebuild (consumers here want the fast path if
        it's cheap, not to pay a tensorization the probes didn't ask for).
        Serves the confirming simulations and the controller's validation
        round, which run between probe queries at generations the probes
        never saw."""
        if cluster is None or self._bundle is None:
            return None
        b = self._bundle
        generation = cluster.consolidation_state()
        if b.generation == generation:
            return b
        if b.generation < generation:
            b2 = self._try_advance(cluster, store, generation, registry)
            if b2 is not None:
                from karpenter_tpu_torch.obs import decisions

                decisions.record_decision("snapshot.advance", "delta",
                                          registry=registry)
            return b2
        return None

    def _try_advance(self, cluster, store, generation, registry):
        """One delta-advance attempt on the cached bundle (shared by
        ``get`` and ``refresh``). Returns the advanced bundle or None
        (opaque/inexpressible/gap)."""
        b = self._bundle
        deltas = getattr(cluster, "deltas_since", lambda g: None)(b.generation)
        if deltas is None:
            self._last_refusal = "journal-gap"
            return None
        if not b.advance(cluster, store, deltas, generation,
                         registry=registry):
            self._last_refusal = b.advance_refusal or "opaque-entry"
            return None
        self._last_refusal = None
        if registry is not None:
            from karpenter_tpu_torch.operator import metrics as m

            registry.counter(
                m.DISRUPTION_SNAPSHOT_CACHE_HITS,
                "disruption probes served from the snapshot cache",
            ).inc(kind="delta")
        return b

    def inputs_for(self, cluster):
        """The cached solver inputs when still generation-current, else
        None — lets the confirming simulations skip re-assembling
        templates/catalog/overhead inside one disruption round. Safe
        because every structural input change bumps the generation and the
        catalog objects are shared by identity."""
        b = self.current(cluster)
        return b.inputs if b is not None else None


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


def _cheapest_cum_vec(prices, j_arr, M):
    """``[N, M]``: for each prefix of the candidates, the cheapest
    positive price seen so far per type (``j_arr``, −1 for none; inf where
    none), one ``np.minimum.accumulate`` per present type: bit-equal to
    the JAX package's loop, ``_cheapest_cum_loop``."""
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
    # the round's shared snapshot acquisition (build or delta-advance),
    # hoisted out of formulate_ms by the controller's prewarm
    "bundle_ms": 0.0,
    # time inside ExistingSnapshot.apply_delta when the cache advanced a
    # snapshot across an eviction wave instead of rebuilding it
    "tensorize_delta_ms": 0.0,
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


class JointSeed:
    """The joint dispatch's answer re-keyed for the per-candidate probes:
    the prefix criterion verdicts ARE MultiNode's capped question over the
    same disruption-cost order (every criterion row depends only on its
    own prefix), and the single rows — when the dispatch carried them —
    ARE SingleNodeConsolidation's per-candidate question scored by the
    shared ``_single_criterion``. So within one cluster-state generation
    the ladder's probes answer off this seed instead of re-paying a device
    dispatch; any state bump invalidates it (generation check at use
    time), and any order/membership mismatch between the querying
    method's candidate list and the seeded pool declines the seed."""

    def __init__(self, generation, pids, prefix_feasible, definitive,
                 single_mask):
        self.generation = generation
        self.pids = tuple(pids)
        self.prefix_feasible = np.asarray(prefix_feasible, dtype=bool)
        self.definitive = bool(definitive)
        self.single_mask = (
            None if single_mask is None
            else np.asarray(single_mask, dtype=bool))

    def valid(self, cluster) -> bool:
        return (cluster is not None
                and cluster.consolidation_state() == self.generation)

    def _aligned(self, pids) -> bool:
        n = len(pids)
        return bool(n) and tuple(pids) == self.pids[:n]

    def prefix_answer(self, pids):
        """``(k, definitive)`` for a capped prefix query over the same
        candidate order — exactly what ``batched_feasible_prefix`` would
        have dispatched — or None when the query is not a prefix of the
        seeded pool."""
        if not self._aligned(pids):
            return None
        feas = self.prefix_feasible[: len(pids)]
        ks = np.flatnonzero(feas)
        return (0 if ks.size == 0 else int(ks[-1]) + 1), self.definitive

    def single_answer(self, pids):
        """``(mask, definitive)`` for a per-candidate query — exactly
        ``batched_single_feasible``'s answer (the joint path is always
        plan-free, so its misses are definitive) — or None when the seed
        carried no single rows or the query order mismatches."""
        if self.single_mask is None or not self._aligned(pids):
            return None
        return self.single_mask[: len(pids)].copy(), True


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
            with obs.span("global.relax", candidates=N):
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
    with obs.span("global.dispatch", rows=rows_total, singles=singles):
        placed_g, used = bundle.dispatch(g_count_k, e_zero_cols,
                                         seam="global.dispatch",
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
