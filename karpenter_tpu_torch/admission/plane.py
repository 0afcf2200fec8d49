"""AdmissionPlane: the tiered cascade + gang + preemption orchestrator.

Sits between the provisioner's pending-pod intake and the solver
(provisioner.schedule routes live batches here when any pod carries a
priority marker or a gang annotation; disruption counterfactuals and
marker-free batches keep the plain single solve). One ``solve_round``:

1. resolve effective priorities (priority.py), collect gangs (gangs.py),
   partition into descending tiers;
2. per tier, gangs first (trial on forked state, promote atomically or
   route whole — ``admission.gang``), then the tier's loose pods through
   the EXISTING batched pack: the shared ExistingNode objects accumulate
   placements across tiers, and prior tiers' claims join the
   existing-node axis as ``ClaimResidual`` rows on the device rung (the
   ops/tensorize.py residual machinery) or as ``initial_claims`` on the
   host rung — so lower tiers pack into the residual capacity of the same
   bundle, one pow-2 compile family across tiers (``admission.tier``);
3. pods still unschedulable walk the preemption ladder in tier order
   (preempt.py: counterfactual batch → confirm-by-real-simulation →
   PDB-gated evictions + nomination — ``admission.preempt``).

A gang-free round FUSES step 2's per-tier cascade into
one device dispatch: the pack kernel's ``g_tier`` axis fences group
order so lower bands pack into the capacity higher bands left behind —
the cascade's residual handoff, device-resident (``_solve_fused``;
parity pinned by tests/test_fused_round.py, rung ``fused`` on
``admission.tier``). Gang rounds keep the cascade: each gang is its own
atomic dispatch. Step 3's victim probes batch the same way
(preempt.py ``probe_feasible_batch``). See deploy/README.md "Fused
cluster round" for the dispatch-cadence and parity contracts.

KARPENTER_ADMISSION=0 disables the whole plane (single-solve behavior);
KARPENTER_FUSED_ROUND=0 restores the per-band dispatch cascade;
KARPENTER_PREEMPTION=0 disables only the preemption ladder;
KARPENTER_PREEMPT_MAX (16) bounds preemptors examined per round and
KARPENTER_PREEMPT_CONFIRMS (4) confirming simulations per preemptor.

The port's copy of ``karpenter_tpu/admission/plane.py`` (imports changed;
``TorchSolver`` where the JAX package tests for ``TPUSolver``, so the
fused round and the residual rows run on the port's solver and a
``HostSolver`` keeps the cascade). The preemption probes run on the
``TorchSolver``'s device, and on the CPU plain path with any other solver
(a ``HostSolver`` is a CPU solver), so the ladder confirms only what the
probe marks feasible, as in the JAX package. Where the JAX
package catches every exception of a gang trial or a probe, the port lets
a device fault (``ops.cuda_kernels.DEVICE_FAULTS``) propagate and falls
back on anything else. Each round records its ``admission.tier``
verdict, each gang its ``admission.gang`` verdict and each examined
preemptor one ``admission.preempt`` verdict on the decision ledger, as
in the JAX package; the round's ``report`` also counts the preemption
probe dispatches (``preempt_probes``).
"""

from __future__ import annotations

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.admission import preempt as _preempt
from karpenter_tpu_torch.admission.fork import (
    fork_claim,
    fork_enode,
    fork_limits,
    fork_topology,
)
from karpenter_tpu_torch.admission.gangs import collect_gangs, inject_colocation
from karpenter_tpu_torch.admission.oracle import debit_limits, placed_uids
from karpenter_tpu_torch.admission.priority import (
    default_class,
    partition_tiers,
    preemption_policy_of,
    resolve_priority,
)
from karpenter_tpu_torch.admission.residual import ClaimResidual
from karpenter_tpu_torch.ops.cuda_kernels import DEVICE_FAULTS
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.models.scheduler import NullTopology, SchedulerResults
from karpenter_tpu_torch.models.solver import HostSolver, TorchSolver
from karpenter_tpu_torch.obs import decisions
from karpenter_tpu_torch.utils.envknobs import env_bool as _env_bool
from karpenter_tpu_torch.utils.envknobs import env_int as _env_int

__all__ = ["AdmissionPlane"]


def _enabled() -> bool:
    return _env_bool("KARPENTER_ADMISSION", True)


def _preempt_enabled() -> bool:
    return _env_bool("KARPENTER_PREEMPTION", True)


def _fused_enabled() -> bool:
    """KARPENTER_FUSED_ROUND (default on): collapse consecutive gang-free
    loose tiers into ONE device solve with the tier axis fencing residual
    capacity on device (deploy/README.md "Fused cluster round").
    KARPENTER_FUSED_ROUND=0 restores the per-tier cascade everywhere —
    the parity oracle the seeded suite pins the fused path against."""
    return _env_bool("KARPENTER_FUSED_ROUND", True)


class _State:
    """The cascade's mutable round state — what a gang trial forks and a
    successful trial promotes."""

    def __init__(self, topology, enodes, claims, limits):
        self.topology = topology
        self.enodes = list(enodes)
        self.claims = list(claims)
        self.limits = limits


class AdmissionPlane:
    def __init__(self, store=None, registry=None, recorder=None, log=None):
        self.store = store
        self.registry = registry
        self.recorder = recorder
        self.log = log

    # -- engagement -------------------------------------------------------
    def engages(self, pods) -> bool:
        """True when the batch carries any admission marker — a priority
        field, a named class, a gang annotation, or (with a store) a
        global-default PriorityClass that would tier the batch."""
        if not _enabled() or not pods:
            return False
        for p in pods:
            if p.priority is not None or p.priority_class_name:
                return True
            if p.metadata.annotations.get(wk.POD_GROUP_ANNOTATION):
                return True
        if self.store is not None:
            for pc in self.store.list("priorityclasses"):
                if pc.global_default and pc.value != 0:
                    return True
        return False

    # -- the round --------------------------------------------------------
    def solve_round(self, solver, pods, templates, its, *, topology=None,
                    existing_nodes=(), daemon_overhead=None, limits=None,
                    volume_topology=None) -> SchedulerResults:
        classes = (
            {pc.name: pc for pc in self.store.list("priorityclasses")}
            if self.store is not None else {}
        )
        dflt = default_class(classes)
        prio_of = {
            p.uid: resolve_priority(p, classes, dflt)[0] for p in pods
        }
        gangs, loose = collect_gangs(pods, prio_of)
        gangs_by_prio: dict = {}
        for g in gangs:
            gangs_by_prio.setdefault(g.priority, []).append(g)
        tiers_loose = dict(partition_tiers(loose, prio_of))
        all_prios = sorted(set(tiers_loose) | set(gangs_by_prio),
                           reverse=True)

        state = _State(topology, existing_nodes, [], fork_limits(limits))
        errors: dict = {}
        report = {
            "tiers": len(all_prios), "gangs_placed": 0, "gangs_routed": 0,
            "preemptions": 0, "evictions": 0, "preempt_declined": 0,
            "preempt_unconfirmed": 0,
            # host-routed pods aggregated across every COMMITTED inner
            # solve (tier solves, mop-ups, promoted gang trials): the
            # solver's last_device_stats only reflects its final call, so
            # the provisioner's accounting reads this instead
            "host_routed": {},
            # solver.solve cadences this round paid (the fused round's
            # headline: >=2 loose tiers collapse to 1; gangs/preempt pay
            # their own) — perf surfaces this as dispatches_per_round
            "solve_dispatches": 0,
            "fused_runs": 0,
            # preemption probe dispatches (one batch over every examined
            # preemptor, or one per preemptor) and host-side probe errors
            # that fell back to direct confirms
            "preempt_probes": {"batch": 0, "single": 0, "errors": 0},
        }
        unplaced: list = []  # (priority, pod) after its tier's solve
        # fused round (deploy/README.md "Fused cluster round"): a
        # gang-free round's loose tiers collapse into ONE device dispatch
        # with the tier axis fencing residual capacity on device.
        # Gang-bearing rounds keep the cascade — each gang is its own
        # atomic dispatch so the round can never reach one dispatch, and
        # the fused scan's open-bin view of higher-tier residuals risks
        # the ±1-bin FFD noise on the gang interleave for a one-dispatch
        # saving; topology-bearing rounds keep the cascade (the waves
        # path ignores tier_of); the host rung keeps the cascade (its
        # FFD loop has no tier axis).
        has_topology = bool(getattr(
            topology, "has_groups",
            topology is not None and not isinstance(topology, NullTopology)))
        fuse = (_fused_enabled() and isinstance(solver, TorchSolver)
                and not has_topology and not gangs_by_prio)
        pending: list = []  # consecutive gang-free prios awaiting one solve

        def flush():
            if not pending:
                return
            run = {prio: list(tiers_loose[prio]) for prio in pending}
            pending.clear()
            if len(run) == 1:
                ((prio, tier_pods),) = run.items()
                missed = self._solve_tier(
                    solver, tier_pods, state, templates, its,
                    daemon_overhead, volume_topology, errors, report)
                unplaced.extend((prio, p) for p in missed)
            else:
                report["fused_runs"] += 1
                unplaced.extend(self._solve_fused(
                    solver, run, state, templates, its, daemon_overhead,
                    volume_topology, errors, report))

        for prio in all_prios:
            gangs_here = gangs_by_prio.get(prio, ())
            if gangs_here:
                flush()
            for gang in gangs_here:
                self._solve_gang(solver, gang, state, templates, its,
                                 daemon_overhead, volume_topology, errors,
                                 report)
            tier_pods = tiers_loose.get(prio, ())
            if not tier_pods:
                continue
            if fuse:
                pending.append(prio)
                continue
            missed = self._solve_tier(
                solver, list(tier_pods), state, templates, its,
                daemon_overhead, volume_topology, errors, report)
            unplaced.extend((prio, p) for p in missed)
        flush()
        decisions.record_decision(
            "admission.tier",
            "fused" if report["fused_runs"]
            else ("cascade" if len(all_prios) > 1 else "single"),
            "ok" if len(all_prios) > 1 else "single-tier",
            registry=self.registry)

        if unplaced and self.store is not None and _preempt_enabled():
            with obs.span("admission.preempt",
                          preemptors=len(unplaced)):
                self._preempt_round(unplaced, prio_of, classes, state,
                                    solver, templates, its,
                                    daemon_overhead, errors, report)

        results = SchedulerResults(
            new_claims=state.claims,
            existing_nodes=list(state.enodes),
            pod_errors=errors,
        )
        results.admission = report
        return results

    @staticmethod
    def _note_routed(solver, report):
        """Fold the last inner solve's host-routed reasons into the
        round's aggregate (one dict across the whole cascade)."""
        routed = (getattr(solver, "last_device_stats", None)
                  or {}).get("host_routed") or {}
        agg = report["host_routed"]
        for reason, n in routed.items():
            if n:
                agg[reason] = agg.get(reason, 0) + n

    # -- one tier's loose pods -------------------------------------------
    def _solve_tier(self, solver, tier_pods, state, templates, its,
                    daemon_overhead, volume_topology, errors,
                    report) -> list:
        """Solve one tier into the shared bundle; returns the tier's
        unplaced pods (in input order)."""
        device_rung = isinstance(solver, TorchSolver)
        residuals = []
        if device_rung:
            residuals = [ClaimResidual(c) for c in state.claims]
            report["solve_dispatches"] += 1
            res = solver.solve(
                tier_pods, templates, its, topology=state.topology,
                existing_nodes=list(state.enodes) + residuals,
                daemon_overhead=daemon_overhead,
                limits=fork_limits(state.limits),
                volume_topology=volume_topology,
            )
            self._note_routed(solver, report)
            new = [c for c in res.new_claims
                   if all(c is not r.claim for r in residuals)]
            originals = {p.uid: p for p in tier_pods}
            mopup = []
            for r in residuals:
                mopup.extend(r.fold(originals))
            if mopup:
                # the exact re-admission refused a device residual commit
                # (merged-requirement narrowing the decode approximates):
                # one host mop-up seeded with every claim settles them.
                # The tier's OWN new claims must debit the limit fork
                # first — Scheduler never charges initial_claims, so an
                # undebited fork would let the mop-up overshoot the pool
                res2 = HostSolver().solve(
                    mopup, templates, its, topology=state.topology,
                    existing_nodes=list(state.enodes),
                    daemon_overhead=daemon_overhead,
                    limits=debit_limits(fork_limits(state.limits), new),
                    initial_claims=state.claims + new,
                    volume_topology=volume_topology,
                )
                new.extend(c for c in res2.new_claims
                           if all(c is not pc
                                  for pc in state.claims + new))
                errors.update(res2.pod_errors)
        else:
            res = solver.solve(
                tier_pods, templates, its, topology=state.topology,
                existing_nodes=list(state.enodes),
                daemon_overhead=daemon_overhead,
                limits=fork_limits(state.limits),
                initial_claims=state.claims,
                volume_topology=volume_topology,
            )
            new = [c for c in res.new_claims
                   if all(c is not pc for pc in state.claims)]
        state.claims.extend(new)
        state.limits = debit_limits(state.limits, new)
        errors.update(res.pod_errors)
        placed = placed_uids(state.claims, state.enodes)
        return [p for p in tier_pods if p.uid not in placed]

    # -- a fused run of gang-free tiers ----------------------------------
    def _solve_fused(self, solver, run, state, templates, its,
                     daemon_overhead, volume_topology, errors,
                     report) -> list:
        """All of ``run``'s tiers in ONE device dispatch: the tier axis
        (``tensorize(..., tier_of=...)``) orders the scan tier-major, so
        higher tiers consume shared and residual capacity first — the
        fence the cascade paid one dispatch per tier for now happens on
        device (deploy/README.md "Fused cluster round"). The mop-up of
        refused residual commits stays a single host pass, re-admitting
        tier-major so precedence survives there too. Returns the run's
        unplaced pods as (priority, pod) for the preemption ladder."""
        prios = sorted(run, reverse=True)
        # dense ranks, higher priority -> higher tier rank; rank 0 is the
        # lowest tier of THIS run, which is all the scan ordering needs
        rank = {prio: len(prios) - 1 - i for i, prio in enumerate(prios)}
        all_pods = [p for prio in prios for p in run[prio]]
        tier_of = {p.uid: rank[prio]
                   for prio in prios for p in run[prio]}
        residuals = [ClaimResidual(c) for c in state.claims]
        report["solve_dispatches"] += 1
        res = solver.solve(
            all_pods, templates, its, topology=state.topology,
            existing_nodes=list(state.enodes) + residuals,
            daemon_overhead=daemon_overhead,
            limits=fork_limits(state.limits),
            volume_topology=volume_topology,
            tier_of=tier_of,
        )
        self._note_routed(solver, report)
        new = [c for c in res.new_claims
               if all(c is not r.claim for r in residuals)]
        originals = {p.uid: p for p in all_pods}
        mopup = []
        for r in residuals:
            mopup.extend(r.fold(originals))
        if mopup:
            # same fork/debit discipline as _solve_tier's mop-up, but the
            # refused pods must queue tier-major or the host FFD would
            # hand a low tier capacity a high tier was refused over
            mopup.sort(key=lambda p: -tier_of.get(p.uid, 0))
            res2 = HostSolver().solve(
                mopup, templates, its, topology=state.topology,
                existing_nodes=list(state.enodes),
                daemon_overhead=daemon_overhead,
                limits=debit_limits(fork_limits(state.limits), new),
                initial_claims=state.claims + new,
                volume_topology=volume_topology,
            )
            new.extend(c for c in res2.new_claims
                       if all(c is not pc for pc in state.claims + new))
            errors.update(res2.pod_errors)
        state.claims.extend(new)
        state.limits = debit_limits(state.limits, new)
        errors.update(res.pod_errors)
        placed = placed_uids(state.claims, state.enodes)
        return [(prio, p) for prio in prios for p in run[prio]
                if p.uid not in placed]

    # -- one gang ---------------------------------------------------------
    def _solve_gang(self, solver, gang, state, templates, its,
                    daemon_overhead, volume_topology, errors, report):
        if len(gang.pods) < gang.min_member:
            self._route_gang(gang, "oversize", errors, report,
                             f"below min-member ({len(gang.pods)} < "
                             f"{gang.min_member})")
            return
        topo = fork_topology(state.topology)
        f_enodes = [fork_enode(en, topo) for en in state.enodes]
        f_claims = [fork_claim(c, topo) for c in state.claims]
        clones = inject_colocation(gang, [p.clone() for p in gang.pods])
        if gang.topology_key and topo is not None:
            # the injected co-location affinity exists only on the clones;
            # the round's topology was built over the originals, so the
            # gang's groups must register on the FORK or the constraint is
            # silently inert (promotion carries the registration forward)
            for c in clones:
                topo.update(c)
        device_rung = isinstance(solver, TorchSolver)
        try:
            if device_rung:
                residuals = [ClaimResidual(c) for c in f_claims]
                report["solve_dispatches"] += 1
                res = solver.solve(
                    clones, templates, its, topology=topo,
                    existing_nodes=f_enodes + residuals,
                    daemon_overhead=daemon_overhead,
                    limits=fork_limits(state.limits),
                    volume_topology=volume_topology,
                )
                new = [c for c in res.new_claims
                       if all(c is not r.claim for r in residuals)]
                for r in residuals:
                    if r.fold():
                        # a refused fold means the trial was NOT fully
                        # placed — the residual's optimistic capacity
                        # over-promised, a capacity event (benign reason),
                        # not a trial malfunction
                        self._route_gang(gang, "infeasible", errors,
                                         report, "residual fold refused")
                        return
            else:
                res = solver.solve(
                    clones, templates, its, topology=topo,
                    existing_nodes=f_enodes,
                    daemon_overhead=daemon_overhead,
                    limits=fork_limits(state.limits),
                    initial_claims=f_claims,
                    volume_topology=volume_topology,
                )
                new = [c for c in res.new_claims
                       if all(c is not fc for fc in f_claims)]
        except DEVICE_FAULTS:
            raise
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "gang trial solve failed; routing group %s", gang.name,
                exc_info=True)
            self._route_gang(gang, "trial-error", errors, report,
                             "trial solve raised")
            return
        placed = placed_uids(f_claims + new, f_enodes)
        if all(p.uid in placed for p in clones):
            # promote the trial wholesale: the fork becomes the live state
            originals = {p.uid: p for p in gang.pods}
            for c in f_claims + new:
                c.pods = [originals.get(p.uid, p) for p in c.pods]
            for node in f_enodes:
                node.pods = [originals.get(p.uid, p) for p in node.pods]
            state.topology = topo
            state.enodes = f_enodes
            state.claims = f_claims + new
            state.limits = debit_limits(fork_limits(state.limits), new)
            report["gangs_placed"] += 1
            self._note_routed(solver, report)  # the trial IS the commit
            decisions.record_decision("admission.gang", "atomic", "ok",
                                      registry=self.registry)
        else:
            starved = any("exceed limits" in str(e)
                          for e in res.pod_errors.values())
            self._route_gang(
                gang, "budget-starved" if starved else "infeasible",
                errors, report, "could not place atomically")

    def _route_gang(self, gang, reason, errors, report, why):
        for p in gang.pods:
            errors[p.key()] = f'pod group "{gang.name}" host-routed: {why}'
        report["gangs_routed"] += 1
        decisions.record_decision("admission.gang", "routed", reason,
                                  registry=self.registry)

    # -- preemption -------------------------------------------------------
    def _preempt_round(self, unplaced, prio_of, classes, state, solver,
                       templates, its, daemon_overhead, errors, report):
        from karpenter_tpu_torch.operator import metrics as m
        from karpenter_tpu_torch.utils.pdb import PdbLimits

        pdb_limits = PdbLimits(self.store)
        taken: set = set()
        max_preempts = _env_int("KARPENTER_PREEMPT_MAX", 16, minimum=0)
        max_confirms = _env_int("KARPENTER_PREEMPT_CONFIRMS", 4, minimum=1)
        ladder = sorted(unplaced, key=lambda t: -t[0])[:max_preempts]
        # the probes run where the round's solver runs: a HostSolver's
        # round probes on the CPU plain path
        device = solver.device if isinstance(solver, TorchSolver) else "cpu"
        probes = self._batch_probe(ladder, prio_of, classes, state,
                                   templates, its, daemon_overhead,
                                   pdb_limits, device, report)
        for prio, pod in ladder:
            outcome = self._preempt_one(
                pod, prio_of, classes, state, templates, its,
                daemon_overhead, pdb_limits, taken, max_confirms, errors,
                report, device, probe=probes.get(pod.uid))
            if self.registry is not None:
                self.registry.counter(
                    m.ADMISSION_PREEMPTIONS,
                    "admission preemption ladder outcomes",
                ).inc(outcome=outcome)

    def _batch_probe(self, ladder, prio_of, classes, state, templates,
                     its, daemon_overhead, pdb_limits, device,
                     report) -> dict:
        """ONE shared counterfactual dispatch for the whole preemption
        ladder (the fused round's preemption leg): every examined
        preemptor's candidate rows fold into one
        ``dispatch_counterfactual_rows`` batch instead of one dispatch
        per preemptor. Candidates are gathered taken-blind — the batch
        cannot know which nodes earlier preemptors will win, and
        ``taken`` only ever EXCLUDES nodes, so re-filtering at selection
        time in ``_preempt_one`` is equivalent to the sequential gather.
        Returns {pod uid: (candidates, feasible-list-or-None)}."""
        pods = [pod for _, pod in ladder
                if preemption_policy_of(pod, classes) != "Never"]
        if not pods:
            return {}
        cand_lists = [
            _preempt.victim_sets(pod, state.enodes, prio_of, classes,
                                 pdb_limits, set())
            for pod in pods]
        feas_lists = None
        if sum(1 for c in cand_lists if c) >= 2:
            try:
                feas_lists = _preempt.probe_feasible_batch(
                    pods, cand_lists, templates, its,
                    daemon_overhead=daemon_overhead, device=device)
                report["preempt_probes"]["batch"] += 1
            except DEVICE_FAULTS:
                raise
            except Exception:
                report["preempt_probes"]["errors"] += 1
                import logging

                logging.getLogger(__name__).warning(
                    "batched preemption probe failed; probing per "
                    "preemptor", exc_info=True)
        if feas_lists is None:
            feas_lists = [None] * len(pods)
        return {pod.uid: (cands, feas)
                for pod, cands, feas in zip(pods, cand_lists, feas_lists)}

    def _preempt_one(self, pod, prio_of, classes, state, templates,
                     its, daemon_overhead, pdb_limits, taken, max_confirms,
                     errors, report, device, probe=None) -> str:
        if preemption_policy_of(pod, classes) == "Never":
            decisions.record_decision("admission.preempt", "skipped",
                                      "policy-never",
                                      registry=self.registry)
            return "skipped"
        feas = None
        have_feas = False
        if probe is not None:
            cands, feas = probe
            if feas is not None:
                have_feas = True
                kept = [(c, ok) for c, ok in zip(cands, feas)
                        if c.node_name not in taken]
                cands = [c for c, _ in kept]
                feas = [ok for _, ok in kept]
            else:
                cands = [c for c in cands if c.node_name not in taken]
        else:
            cands = _preempt.victim_sets(pod, state.enodes, prio_of,
                                         classes, pdb_limits, taken)
        if not cands:
            decisions.record_decision("admission.preempt", "skipped",
                                      "no-victims", registry=self.registry)
            return "skipped"
        probe_error = False
        if not have_feas:
            try:
                feas = _preempt.probe_feasible(
                    pod, cands, templates, its,
                    daemon_overhead=daemon_overhead, device=device)
                report["preempt_probes"]["single"] += 1
            except DEVICE_FAULTS:
                raise
            except Exception:
                report["preempt_probes"]["errors"] += 1
                import logging

                logging.getLogger(__name__).warning(
                    "preemption probe failed; confirming sequentially",
                    exc_info=True)
                # no verdict yet: the ladder records exactly ONE per
                # examined preemptor — the probe-error cause rides a
                # declining verdict below; a confirm that still lands
                # records confirmed/ok
                probe_error = True
                feas = None
        # probe misses stay misses (seeds are trusted negative only up to
        # the bounded confirm budget below); inexpressible probes confirm
        # the cheapest candidates directly — the reference-cost path
        ordered = (
            [c for c, ok in zip(cands, feas) if ok]
            if feas is not None else list(cands)
        )
        if not ordered:
            decisions.record_decision(
                "admission.preempt", "declined",
                "probe-error" if probe_error else "no-feasible-node",
                registry=self.registry)
            report["preempt_declined"] += 1
            return "declined"
        confirmed = None
        for cand in ordered[:max_confirms]:
            trimmed = _preempt.trim_and_confirm(pod, cand, state.topology)
            if trimmed is not None:
                confirmed = trimmed
                break
            report["preempt_unconfirmed"] += 1
        if confirmed is None:
            decisions.record_decision(
                "admission.preempt", "declined",
                "probe-error" if probe_error else "confirm-failed",
                registry=self.registry)
            report["preempt_declined"] += 1
            return "declined"
        evicted, complete = _preempt.execute_evictions(
            self.store, confirmed, pod, recorder=self.recorder,
            registry=self.registry)
        report["evictions"] += evicted
        if not complete:
            # a PDB that closed mid-set: whatever shipped stays shipped
            # (its capacity returns to the pool) but the preemptor is NOT
            # nominated and keeps its scheduling error for the next round
            decisions.record_decision("admission.preempt", "declined",
                                      "pdb-blocked", registry=self.registry)
            report["preempt_declined"] += 1
            return "declined"
        taken.add(confirmed.node_name)
        report["preemptions"] += 1
        # the preemptor is nominated, not failed: drop its error so the
        # round doesn't publish FailedScheduling for a pod mid-preemption
        errors.pop(pod.key(), None)
        decisions.record_decision("admission.preempt", "confirmed", "ok",
                                  registry=self.registry)
        return "confirmed"
