"""Disruption methods, tried in order — first success wins.

Mirror of the reference's method set (disruption/controller.go:80-91):
Drift → Emptiness → EmptyNodeConsolidation → MultiNodeConsolidation →
SingleNodeConsolidation. Consolidation shares `compute_consolidation`
(consolidation.go:112-296): simulate, require every displaced pod to
schedule, allow at most one replacement node, and apply the price filter
(the replacement must be launchable strictly cheaper than what the
candidates currently cost; spot→spot additionally requires the feature gate
and ≥15 cheaper types to prevent churn).

The port's copy of ``karpenter_tpu/controllers/disruption/methods.py``
(imports changed; ``TorchSolver`` where the JAX package tests for
``TPUSolver``). Each ladder records its ``(site, rung, reason)`` verdict
on the decision ledger (``disrupt.interruption``, ``consolidate.global``,
``probe.confirm``; obs/decisions.py) and its spans and anomalies on the
flight recorder, at the JAX package's sites. Left out: the capsule seams
(ROADMAP.md Queue 1 item 1).

A device probe's own inexpressible shapes fall back to the sequential
search as in the JAX package, and so does any host-side exception, which
is counted in ``DISRUPTION_PROBE_FAILURES``; a kernel that does not build
or launch, or a CUDA error, is not a probe failure and propagates
(``ops.cuda_kernels.DEVICE_FAULTS``; ``NotImplementedError`` and
``RecursionError`` subclass ``RuntimeError`` but are host-side, and fall
back).
"""

from __future__ import annotations

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.nodeclaim import COND_DRIFTED, COND_EMPTY
from karpenter_tpu_torch.api.nodepool import (
    CONSOLIDATION_WHEN_EMPTY,
    CONSOLIDATION_WHEN_UNDERUTILIZED,
    REASON_DRIFTED,
    REASON_EMPTY,
    REASON_INTERRUPTED,
    REASON_UNDERUTILIZED,
)
from karpenter_tpu_torch.controllers.disruption.helpers import (
    simulate_scheduling,
    within_budget,
)
from karpenter_tpu_torch.controllers.disruption.types import Command
from karpenter_tpu_torch.ops.cuda_kernels import DEVICE_FAULTS

MULTI_NODE_CANDIDATE_CAP = 100  # multinodeconsolidation.go:82
SPOT_TO_SPOT_MIN_TYPES = 15  # consolidation.go:253-277
MULTI_NODE_TIMEOUT = 60.0  # multinodeconsolidation.go:37
SINGLE_NODE_TIMEOUT = 180.0  # singlenodeconsolidation.go:46


class Method:
    reason: str = ""
    needs_validation: bool = False
    # consolidation methods honor the isConsolidated fence: skipped while
    # cluster state is unchanged since the last fruitless search
    is_consolidation: bool = False
    # the decision-ledger site whose verdict shipped this method's
    # commands — the fleet ledger stamps it on every command's cause
    # chain (obs/timeline.py); empty for methods without a ladder site
    decision_site: str = ""

    def __init__(self, ctx):
        self.ctx = ctx  # DisruptionContext: provisioner, cluster, store, clock, options

    def compute_command(self, candidates, budgets) -> Command | None:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


def _claim_condition(candidate, cond) -> bool:
    claim = candidate.state_node.node_claim
    return claim is not None and claim.is_true(cond)


class Drift(Method):
    """Replace nodes whose claims carry the Drifted condition
    (disruption/drift.go:35-115)."""

    reason = REASON_DRIFTED

    def compute_command(self, candidates, budgets):
        drifted = [c for c in candidates if _claim_condition(c, COND_DRIFTED)]
        drifted.sort(
            key=lambda c: (
                c.state_node.node_claim.get_condition(COND_DRIFTED).last_transition_time
            )
        )
        drifted = within_budget(budgets, self.reason, drifted)
        if not drifted:
            return None
        # empty drifted candidates can all go at once, no simulation
        empty = [c for c in drifted if not c.reschedulable_pods]
        if empty:
            return Command(empty, reason=self.reason)
        # else one at a time, with replacement simulation (sharing the
        # round's cached solver inputs when still generation-current)
        ctx = self.ctx
        cache = getattr(ctx, "snapshot_cache", None)
        bundle = (
            cache.refresh(ctx.provisioner, ctx.cluster, ctx.store,
                          registry=ctx.registry)
            if cache is not None else None
        )
        inputs = cache.inputs_for(ctx.cluster) if cache is not None else None
        for c in drifted:
            with obs.span("confirm.simulate", method="drift"):
                sim = simulate_scheduling(
                    self.ctx.provisioner, self.ctx.cluster, self.ctx.store,
                    [c], inputs=inputs, bundle=bundle,
                )
            if not sim.all_pods_scheduled():
                continue
            return Command([c], replacements=sim.new_claims, reason=self.reason)
        return None


class Emptiness(Method):
    """Delete nodes empty for ≥ consolidateAfter under WhenEmpty
    (disruption/emptiness.go:32-85). No simulation."""

    reason = REASON_EMPTY

    def compute_command(self, candidates, budgets):
        clock = self.ctx.clock
        empty = []
        for c in candidates:
            if c.node_pool.spec.disruption.consolidation_policy != CONSOLIDATION_WHEN_EMPTY:
                continue
            claim = c.state_node.node_claim
            if claim is None or not claim.is_true(COND_EMPTY):
                continue
            if c.reschedulable_pods:
                continue
            wait = c.node_pool.spec.disruption.consolidate_after or 0.0
            cond = claim.get_condition(COND_EMPTY)
            since = cond.last_transition_time if cond is not None else None
            if since is None:
                # condition present but its transition time unset (partial
                # status write, wire-doc normalization gap): the age gate
                # cannot be proven, so the node is NOT yet eligible — skip
                # it this round instead of raising mid-ladder
                continue
            if clock.now() - since < wait:
                continue
            empty.append(c)
        empty = within_budget(budgets, self.reason, empty)
        if not empty:
            return None
        return Command(empty, reason=self.reason)


class InterruptionDrain(Method):
    """Proactive spot drain-and-replace. An interruption notice marks the
    node on cluster state (``Cluster.note_interruption``, pulled from the
    cloud provider by the disruption controller); this method — ordered
    before every consolidation method, because a reclaim deadline
    outranks any voluntary optimization — ships ONE command per
    notice-bearing round:

    * **proactive** (the top rung): one counterfactual row on the round's
      cached :class:`DisruptionSnapshot` (``bundle.dispatch``) asks
      whether the SURVIVORS absorb every displaced pod, then the
      confirming ``simulate_scheduling`` sizes the actual replacement
      claims — and because ``needs_validation`` is False the command
      executes this round: replacements launch immediately, the
      orchestration queue holds the candidate-claim deletion until every
      replacement is Initialized, and only then does the PDB-gated drain
      wave ship. A notice with ≥1 round of lead therefore never loses a
      pod to the reclaim.
    * **degraded**: a deadline already inside
      ``KARPENTER_INTERRUPTION_MIN_LEAD`` (30 s) — or one that arrives
      MID-SOLVE (the simulation outran the clock) — degrades to an
      immediate drain with no replacement wait.
    * **reactive**: the replacement solve cannot place the pods (no
      capacity); the node drains bare and the provisioner's
      deleting-node pre-provisioning rescues what it can post-drain.

    Interruption is INVOLUNTARY disruption: budgets are not consulted
    and nodes the candidate filters exclude (do-not-disrupt,
    PDB-blocked) are still drained — a blocked eviction retries until the
    deadline kills the node. Every round records one
    ``disrupt.interruption`` decision-ledger verdict (closed enums,
    obs/decisions.py)."""

    reason = REASON_INTERRUPTED
    needs_validation = False  # a validation TTL would eat the deadline
    decision_site = "disrupt.interruption"
    last_rung: str = ""  # "proactive" | "reactive" | "degraded" (tests)

    @property
    def uses_bundle(self) -> bool:
        """Ask the controller to prewarm the round's snapshot ONLY when a
        live notice exists: the absorb probe rides the bundle, but a
        notice-free round must not pay a fleet tensorization for a method
        that returns None immediately."""
        cluster = getattr(self.ctx, "cluster", None)
        return cluster is not None and cluster.interruptions_pending()

    def _verdict(self, rung, reason="ok"):
        from karpenter_tpu_torch.obs import decisions

        self.last_rung = rung
        decisions.record_decision("disrupt.interruption", rung, reason,
                                  registry=self.ctx.registry)

    def compute_command(self, candidates, budgets):
        self.last_rung = ""
        noticed = self._noticed(candidates)
        if not noticed:
            return None
        ctx = self.ctx
        from karpenter_tpu_torch.operator import metrics as m
        from karpenter_tpu_torch.utils.envknobs import env_float

        min_lead = env_float("KARPENTER_INTERRUPTION_MIN_LEAD", 30.0,
                             minimum=0.0)
        # PARTITION by lead, never aggregate: one short-lead notice must
        # not degrade nodes whose deadlines still leave room for the
        # proactive replace — the urgent subset drains NOW and the
        # with-lead rest rides the next poll, still inside its lead
        urgent = [c for dl, c in noticed
                  if ctx.clock.now() + min_lead > dl]
        if urgent:
            return self._degrade(urgent)
        deadline = min(dl for dl, _ in noticed)
        cands = [c for _, c in noticed]
        absorbed = self._absorb_probe(cands)
        if absorbed:
            # the device row says the SURVIVORS absorb every displaced pod
            # with zero fresh claims: ship the delete-only drain without
            # paying the host simulation. The probe can only OVER-estimate
            # (f32 fit): a wrong "absorbed" leaves pods pending post-drain
            # and the provisioner re-provisions them next round
            self._verdict("proactive", "delete-only")
            ctx.registry.counter(
                m.INTERRUPTION_PROACTIVE_DRAINS,
                "interruption-noticed nodes drained proactively "
                "(replacement launched-and-ready before the drain wave)",
            ).inc(len(cands))
            return Command(cands, reason=self.reason)
        cache = getattr(ctx, "snapshot_cache", None)
        bundle = (
            cache.refresh(ctx.provisioner, ctx.cluster, ctx.store,
                          registry=ctx.registry)
            if cache is not None else None
        )
        inputs = cache.inputs_for(ctx.cluster) if cache is not None else None
        with obs.span("confirm.simulate", method="interruption",
                      noticed=len(cands), absorbed=absorbed):
            sim = simulate_scheduling(
                ctx.provisioner, ctx.cluster, ctx.store, cands,
                inputs=inputs, bundle=bundle,
            )
        if ctx.clock.now() + min_lead > deadline:
            # a deadline arrived mid-solve: degrade the now-urgent subset
            # instead of wedging (the rest retries next poll)
            urgent = [c for dl, c in noticed
                      if ctx.clock.now() + min_lead > dl]
            return self._degrade(urgent or cands)
        if not sim.all_pods_scheduled():
            self._verdict("reactive", "reactive-fallback")
            return Command(cands, reason=self.reason)
        self._verdict("proactive",
                      "ok" if sim.new_claims else "delete-only")
        ctx.registry.counter(
            m.INTERRUPTION_PROACTIVE_DRAINS,
            "interruption-noticed nodes drained proactively (replacement "
            "launched-and-ready before the drain wave)",
        ).inc(len(cands))
        return Command(cands, replacements=sim.new_claims,
                       reason=self.reason)

    def _degrade(self, cands):
        from karpenter_tpu_torch.operator import metrics as m

        self._verdict("degraded", "deadline-degraded")
        self.ctx.registry.counter(
            m.INTERRUPTION_DEADLINE_DEGRADATIONS,
            "interruption notices whose deadline forced the immediate-"
            "drain degradation (no replacement wait)",
        ).inc(len(cands))
        return Command(cands, reason=self.reason)

    def _noticed(self, candidates):
        """[(deadline, Candidate)] for every live noticed node, soonest
        first. Candidates the controller's filters excluded
        (do-not-disrupt, PDB) are rebuilt directly — an interruption
        ignores voluntary-disruption gates."""
        ctx = self.ctx
        if getattr(ctx, "cluster", None) is None:
            return []
        by_pid = {c.provider_id: c for c in candidates}
        out = []
        view = None
        for sn in list(ctx.cluster.state_nodes()):
            if not sn.interruption_pending():
                continue
            dl = sn.interruption_deadline
            c = by_pid.get(sn.provider_id)
            if c is None:
                if view is None:
                    from karpenter_tpu_torch.cloudprovider.types import (
                        CatalogView,
                    )

                    view = CatalogView(ctx.store.list("nodepools"),
                                       ctx.cloud)
                c = self._make_candidate(sn, view)
                if c is None:
                    continue
            out.append((dl, c))
        out.sort(key=lambda t: t[0])
        return out

    def _make_candidate(self, sn, view):
        from karpenter_tpu_torch.controllers.disruption.types import (
            Candidate,
        )

        labels = sn.labels()
        np_ = view.pool_of(labels)
        if np_ is None:
            return None
        it = (view.instance_type(labels)
              if getattr(self.ctx, "cloud", None) is not None else None)
        return Candidate(sn.snapshot(), np_, it, self.ctx.clock)

    def _absorb_probe(self, cands):
        """One counterfactual row on the cached bundle's dispatch: do the
        SURVIVING nodes absorb every noticed node's pods with zero fresh
        claims? ``True`` short-circuits the host simulation (a delete-only
        drain ships immediately); ``False``/``None`` hands the decision to
        the simulation. None when the bundle cannot express the query,
        and when the probe fails on the host — counted in
        ``DISRUPTION_PROBE_FAILURES``, since a probe failure must never
        block an interruption drain. A device fault propagates."""
        import numpy as np

        ctx = self.ctx
        cache = getattr(ctx, "snapshot_cache", None)
        bundle = cache.current(ctx.cluster) if cache is not None else None
        if bundle is None:
            return None
        try:
            cols = bundle.columns_for(cands)
            if cols is None:
                return None
            contrib = bundle.contribs_for(cands, cols=cols)
            if contrib is None:
                return None
            need = contrib.sum(axis=0)
            row = (bundle.base + need)[None, :]
            with obs.span("interruption.probe", candidates=len(cands)):
                placed_g, used = bundle.dispatch(
                    row, [np.asarray(cols, dtype=np.intp)],
                    seam="interruption.dispatch")
            G = bundle.snap.G
            return bool((placed_g[0, :G] >= need).all()
                        and int(used[0]) == 0)
        except DEVICE_FAULTS:
            raise
        except Exception:
            import logging

            _probe_failure(ctx, "interruption")  # counted, no verdict
            logging.getLogger(__name__).warning(
                "interruption absorb probe failed; the confirming "
                "simulation decides alone", exc_info=True)
            return None


def _consolidatable(candidates):
    out = []
    for c in candidates:
        d = c.node_pool.spec.disruption
        if d.consolidation_policy != CONSOLIDATION_WHEN_UNDERUTILIZED:
            continue
        out.append(c)
    return out


def _candidate_order(ctx, pool):
    """ONE disruption-cost order shared by GlobalConsolidation,
    MultiNodeConsolidation, and SingleNodeConsolidation — sharing it is
    what lets the joint dispatch's seed answer the per-candidate probes
    (ops/consolidate.py ``JointSeed`` aligns by pid sequence, and a
    method sorting differently would decline every seed).

    Primary key: ``disruption_cost`` (the reference's order). Secondary
    key (the priority lever's first slice):
    on EXACT cost ties only, prefer retiring the candidate displacing
    lower-tier pods — effective priority per admission/priority.py's
    apiserver matrix, keyed ``(max tier, summed tier)`` over the node's
    reschedulable pods. The sort is stable and a priority-free fleet
    resolves every tier key to ``(0, 0)``, so end states without
    priorities are bit-identical to the plain cost sort. Tier
    resolution is paid only for the candidates actually inside a tie
    run, and the whole order is memoized per (generation, pool) on the
    DisruptionContext — all three methods order the SAME candidate
    objects within one round, so the second and third calls are a tuple
    compare."""
    cluster = getattr(ctx, "cluster", None)
    key = None
    if cluster is not None:
        key = (cluster.consolidation_state(),
               tuple(c.provider_id for c in pool))
        memo = getattr(ctx, "order_memo", None)
        if memo is not None and memo[0] == key:
            return list(memo[1])
    out = _compute_candidate_order(ctx, pool)
    if key is not None:
        ctx.order_memo = (key, out)
    return list(out)


def _compute_candidate_order(ctx, pool):
    pool = sorted(pool, key=lambda c: c.disruption_cost)
    if len(pool) < 2 or getattr(ctx, "store", None) is None:
        return pool
    # tie runs of equal cost: only their members pay tier resolution
    runs = []
    i = 0
    while i < len(pool):
        j = i + 1
        while j < len(pool) and (
                pool[j].disruption_cost == pool[i].disruption_cost):
            j += 1
        if j - i > 1:
            runs.append((i, j))
        i = j
    if not runs:
        return pool  # all distinct: the tie-break can never reorder
    from karpenter_tpu_torch.admission.priority import (
        default_class,
        resolve_priority,
    )

    classes = {
        pc.metadata.name: pc for pc in ctx.store.list("priorityclasses")
    }
    dflt = default_class(classes)

    def tier_key(c):
        prios = [
            resolve_priority(p, classes, dflt)[0]
            for p in c.reschedulable_pods
        ]
        return (max(prios, default=0), sum(prios))

    # a stable per-run re-sort is exactly the global (cost, tier) sort:
    # runs are maximal equal-cost spans, so keys never cross runs
    for i, j in runs:
        pool[i:j] = sorted(pool[i:j], key=tier_key)
    return pool


def _seed_answer(ctx, cands, kind):
    """The joint dispatch's seed answer for a per-candidate probe
    (ops/consolidate.py ``JointSeed``), or None: the seed must be from
    the SAME cluster-state generation (any state bump invalidates it)
    and the querying method's candidate list must be a prefix of the
    seeded pool in the shared order. Records nothing — the caller
    records the probe.confirm verdict with reason ``joint-seeded``."""
    seed = getattr(ctx, "joint_seed", None)
    if seed is None or not seed.valid(getattr(ctx, "cluster", None)):
        return None
    pids = tuple(c.provider_id for c in cands)
    if kind == "prefix":
        return seed.prefix_answer(pids)
    return seed.single_answer(pids)


class EmptyNodeConsolidation(Method):
    """Bulk-delete empty nodes under WhenUnderutilized
    (disruption/emptynodeconsolidation.go:30-115)."""

    reason = REASON_EMPTY
    needs_validation = True
    is_consolidation = True

    def compute_command(self, candidates, budgets):
        empty = [c for c in _consolidatable(candidates) if not c.reschedulable_pods]
        empty = within_budget(budgets, self.reason, empty)
        if not empty:
            return None
        return Command(empty, reason=self.reason)


def candidate_prices(candidates) -> float | None:
    """Sum of the candidates' current offering prices, or None when ANY
    candidate's price is unknown (delisted offering, price <= 0) — the
    reference's getCandidatePrices error stance (consolidation.go:86-97):
    an unpriceable node cannot anchor a "strictly cheaper" comparison, and
    silently summing it as 0 understates the current cost, letting a
    replacement pass against a candidate set it may not actually beat."""
    total = 0.0
    for c in candidates:
        p = c.price
        if p <= 0:
            return None
        total += p
    return total


def predicted_command_savings(cmd) -> float | None:
    """Criterion-predicted savings RATE of a command at execution time:
    the candidates' summed effective price minus the cheapest effective
    offering each replacement claim can still launch as — the number the
    fleet ledger reconciles against realized savings when the command
    completes (obs/timeline.py). None when either side is unpriceable
    (the :func:`candidate_prices` stance: an unknown price cannot anchor
    a reconciliation)."""
    current = candidate_prices(cmd.candidates)
    if current is None:
        return None
    from karpenter_tpu_torch.cloudprovider.types import effective_price, risk_lambda

    lam = risk_lambda()  # hoisted: one env read, not one per offering
    replacement = 0.0
    for claim in cmd.replacements:
        best = None
        for it in claim.instance_types:
            for o in it.offerings.available().compatible(claim.requirements):
                p = effective_price(o, lam)
                if p > 0 and (best is None or p < best):
                    best = p
        if best is None:
            return None
        replacement += best
    return current - replacement


def compute_consolidation(ctx, candidates) -> Command | None:
    """Shared consolidation core (consolidation.go:112-296)."""
    cache = getattr(ctx, "snapshot_cache", None)
    bundle = (
        cache.refresh(ctx.provisioner, ctx.cluster, ctx.store,
                      registry=ctx.registry)
        if cache is not None else None
    )
    inputs = cache.inputs_for(ctx.cluster) if cache is not None else None
    sim = simulate_scheduling(
        ctx.provisioner, ctx.cluster, ctx.store, candidates, inputs=inputs,
        bundle=bundle,
    )
    if not sim.all_pods_scheduled():
        return None
    if len(sim.new_claims) == 0:
        return Command(candidates, reason=REASON_UNDERUTILIZED)
    if len(sim.new_claims) > 1:
        return None  # m→1 replacement only (consolidation.go:164)

    replacement = sim.new_claims[0]
    current_price = candidate_prices(candidates)
    if current_price is None:
        return None  # unpriceable candidate: abort the replacement path
    all_spot = all(c.capacity_type == wk.CAPACITY_TYPE_SPOT for c in candidates)

    # the replacement must launch strictly cheaper than the candidates cost
    # now: filter its instance types to the cheaper-than-current set
    # (consolidation.go filterByPrice:210), keeping the comparison price
    # (spot-only when the whole candidate set is spot). Both sides of the
    # comparison are risk-discounted EFFECTIVE prices (candidate_prices
    # reads Candidate.price, which already is), so with λ > 0 a
    # consolidation only ships when the replacement is cheaper risk
    # included — a nominally-cheap high-risk offering does not buy churn
    from karpenter_tpu_torch.cloudprovider.types import effective_price, risk_lambda
    lam = risk_lambda()  # hoisted: one env read, not one per offering
    priced = []
    for it in replacement.instance_types:
        ofs = it.offerings.available().compatible(replacement.requirements)
        if all_spot:
            # spot→spot: compare within spot offerings only
            ofs = type(ofs)(o for o in ofs if o.capacity_type == wk.CAPACITY_TYPE_SPOT)
        if not ofs:
            continue
        p = min(effective_price(o, lam) for o in ofs)
        if p < current_price:
            priced.append((p, it))
    if not priced:
        return None

    if all_spot:
        if not ctx.options.get("spot_to_spot_consolidation", False):
            return None  # feature-gated (consolidation.go:214)
        if len(candidates) == 1 and len(priced) < SPOT_TO_SPOT_MIN_TYPES:
            return None  # anti-churn floor (consolidation.go:253-277)
        # keep the CHEAPEST 15 by the same SPOT-ONLY price the filter used
        # (the reference price-sorts its options before slicing,
        # consolidation.go:269): launching from the cheapest spot band is
        # the whole point of the churn — an on-demand offering priced
        # under a type's spot price must not buy it a slot
        priced.sort(key=lambda t: (t[0], t[1].name))
        priced = priced[:SPOT_TO_SPOT_MIN_TYPES]
    # else: on-demand (or mixed) candidates keep both capacity types and
    # the full cheaper set, in the replacement's original (price) order

    replacement.instance_types = [it for _, it in priced]
    return Command(candidates, replacements=[replacement], reason=REASON_UNDERUTILIZED)


def confirm_consolidation(ctx, cands, method_label, **span_attrs):
    """ONE real simulation of a candidate set, with the same-type price
    filter applied to any replacement — the confirm contract shared
    verbatim by the MultiNode prefix and the global joint set (ONE copy,
    so the "identical confirm contract" guarantee cannot drift; the
    unknown-price stance rides inside: candidate_prices aborting the
    replace path in compute_consolidation keeps commands delete-only
    whenever a candidate cannot be priced). None = the set fails."""
    from karpenter_tpu_torch.operator import metrics as m

    ctx.registry.counter(
        m.DISRUPTION_HOST_CONFIRMS,
        "confirming host simulations run by consolidation methods",
    ).inc(method=method_label)
    with obs.span("confirm.simulate", method=method_label, **span_attrs), \
            ctx.registry.measure(m.DISRUPTION_CONFIRM_DURATION,
                                 method=method_label):
        cmd = compute_consolidation(ctx, cands)
    if cmd is None or cmd.action == "no-op":
        return None
    if cmd.action == "replace":
        kept = filter_out_same_type(cmd.replacements[0], cands)
        if not kept:
            return None
        cmd.replacements[0].instance_types = kept
    return cmd


def filter_out_same_type(replacement, candidates) -> list:
    """Price-sanity filter for m→1 replacements
    (multinodeconsolidation.go:181-215): when the replacement's instance-type
    options include a type we are deleting, drop every option that is not
    strictly cheaper than the cheapest such overlapping node — otherwise the
    "consolidation" would relaunch one of its own victims, which is just a
    delete with extra churn. All comparisons run on risk-discounted
    EFFECTIVE prices (Candidate.price and effective_price; nominal at λ=0).

    A same-type candidate with UNKNOWN price (delisted offering, price <= 0)
    cannot anchor the strictly-cheaper comparison directly. The original
    ADVICE.md round-5 stance dropped its type from the options outright
    (delete-only direction). Under λ > 0 that blanket stance narrows (the
    round-5 gap close): when the delisted candidate's type still has an
    available, priced offering of the OTHER capacity type whose risk is
    KNOWN, that offering's effective price anchors the comparison instead
    — pricing the same-type spot↔on-demand move the old stance forbade.
    A type with no such risk-known cross-capacity offering — or any
    λ=0 deployment (the anchor is λ-gated so the risk-blind default is
    bit-identical to the risk-blind behavior) — keeps the conservative
    delete-only treatment: we still never buy what we can't price."""
    existing_prices: dict = {}
    unknown_types: set = set()
    for c in candidates:
        if c.instance_type is None:
            continue
        p = c.price
        if p <= 0:
            anchor = _cross_capacity_anchor(c)
            if anchor is None:
                unknown_types.add(c.instance_type.name)
                continue
            p = anchor
        prev = existing_prices.get(c.instance_type.name)
        if prev is None or p < prev:
            existing_prices[c.instance_type.name] = p
    # a type is unpriceable only when NO candidate of it has a known price:
    # a mixed type (one delisted node, one priced node) keeps both its
    # anchor and its option slot — the priced node bounds the comparison
    unknown_types -= set(existing_prices)
    options = [
        it for it in replacement.instance_types if it.name not in unknown_types
    ]
    max_price = float("inf")
    for it in replacement.instance_types:
        if it.name in existing_prices:
            max_price = min(max_price, existing_prices[it.name])
    if max_price == float("inf"):
        return options
    from karpenter_tpu_torch.cloudprovider.types import effective_price, risk_lambda

    lam = risk_lambda()  # hoisted: one env read, not one per offering
    kept = []
    for it in options:
        ofs = it.offerings.available().compatible(replacement.requirements)
        if ofs and min(effective_price(o, lam) for o in ofs) < max_price:
            kept.append(it)
    return kept


def _cross_capacity_anchor(c) -> float | None:
    """Effective price anchoring an unpriceable candidate's same-type
    comparison through the OTHER capacity type: the cheapest available,
    priced offering of ``c.instance_type`` in a different capacity type
    whose ``interruption_risk`` is KNOWN (not None). None = no such
    offering, keep the delete-only stance (filter_out_same_type).

    Gated on λ > 0: the anchor only engages once the operator has opted
    into risk-discounted economics, so the default λ=0 deployment keeps
    the risk-blind delete-only behavior EXACTLY (the λ=0 bit-parity
    acceptance covers behavior, not just the price tensors)."""
    from karpenter_tpu_torch.cloudprovider.types import effective_price, risk_lambda

    lam = risk_lambda()
    if lam <= 0.0 or c.instance_type is None:
        return None
    ct = getattr(c, "capacity_type", "")
    best = None
    for o in c.instance_type.offerings.available():
        if o.capacity_type == ct or o.price <= 0:
            continue
        if o.interruption_risk is None:
            continue  # unknown risk: cannot vouch for the move
        p = effective_price(o, lam)
        if best is None or p < best:
            best = p
    return best


def _probe_failure(ctx, method_label, site=None):
    """ONE copy of the probe-failure diagnosis (counter + anomaly +
    sequential verdict), shared by the per-candidate probes and the
    global joint solve. Falling back is by design (the probes are
    prefilters), but the reason must stay diagnosable — a permanently-
    failing probe silently costs every consolidation round its batched
    dispatch; the counter makes it visible on the scrape. The
    interruption drain's absorb probe passes no ``site``: it only counts,
    as the JAX package's records no anomaly or verdict there."""
    from karpenter_tpu_torch.obs import decisions
    from karpenter_tpu_torch.operator import metrics as m

    ctx.registry.counter(
        m.DISRUPTION_PROBE_FAILURES,
        "device consolidation probes that fell back to the "
        "sequential search",
    ).inc(method=method_label)
    if site is None:
        return
    # anomaly trigger: a fallback costs the round its batched dispatch
    # — the flight recorder keeps this round's span tree so the
    # failing stage is attributable from the dump, not just counted
    obs.anomaly("probe-fallback", registry=ctx.registry,
                method=method_label)
    decisions.record_decision(site, "sequential", "probe-error",
                              registry=ctx.registry)


def _device_probe(ctx, probe_fn, method_label, cands, pool):
    """Shared probe runner for both per-candidate consolidation methods:
    the TorchSolver gate, the exception fallback (`_probe_failure`), and
    the batch-size histogram. The sequential verdicts (``no-device``,
    ``probe-error``, ``inexpressible``) are recorded here; the caller
    records the ladder's own."""
    from karpenter_tpu_torch.models.solver import TorchSolver
    from karpenter_tpu_torch.obs import decisions

    if not isinstance(getattr(ctx.provisioner, "solver", None), TorchSolver):
        decisions.record_decision("probe.confirm", "sequential", "no-device",
                                  registry=ctx.registry)
        return None
    try:
        with obs.span("probe", method=method_label, candidates=len(cands)):
            out = probe_fn(
                ctx.provisioner, ctx.cluster, ctx.store, cands,
                cache=getattr(ctx, "snapshot_cache", None),
                registry=ctx.registry,
                # the snapshot is built over the FULL consolidatable pool
                # so MultiNode's and SingleNode's probes share one
                # tensorization
                build_candidates=pool,
            )
    except DEVICE_FAULTS:
        raise
    except Exception:
        import logging

        _probe_failure(ctx, method_label, "probe.confirm")
        logging.getLogger(__name__).warning(
            "device consolidation probe (%s) failed; using the sequential "
            "search", method_label, exc_info=True)
        return None
    if out is None:
        # the probe could not express the scenario (no bundle, invisible
        # candidate, unmapped pods): the method runs the reference search
        decisions.record_decision("probe.confirm", "sequential",
                                  "inexpressible", registry=ctx.registry)
        return None
    from karpenter_tpu_torch.operator import metrics as m

    ctx.registry.histogram(
        m.DISRUPTION_PROBE_BATCH_SIZE,
        "counterfactual rows ranked per batched probe dispatch",
        buckets=m.PROBE_BATCH_BUCKETS,
    ).observe(len(cands), method=method_label)
    return out


# sentinel distinguishing a scan the wall clock cut short from one that
# exhausted (and thereby CLEARED) its candidates — the single-node
# back-check must never treat "never checked" as "rejected"
_TIMED_OUT = object()


def _search_timed_out(ctx, deadline, search_type) -> bool:
    """Wall-clock budget check shared by both consolidation searches
    (multinodeconsolidation.go:37, singlenodeconsolidation.go:46)."""
    if ctx.clock.now() <= deadline:
        return False
    from karpenter_tpu_torch.operator import metrics as m

    ctx.registry.counter(
        m.CONSOLIDATION_TIMEOUTS, "consolidation searches cut off by wall clock"
    ).inc(type=search_type)
    return True


def _global_enabled() -> bool:
    from karpenter_tpu_torch.utils.envknobs import env_bool

    return env_bool("KARPENTER_GLOBAL_CONSOLIDATION", True)


def _global_cap() -> int:
    from karpenter_tpu_torch.utils.envknobs import env_int

    return env_int("KARPENTER_GLOBAL_CAP", GLOBAL_CANDIDATE_CAP, minimum=2)


# joint-ladder row ceiling: far above any real fleet (the 2k config is the
# headline), it only bounds the counterfactual row count a pathological
# candidate list could enqueue in one dispatch
GLOBAL_CANDIDATE_CAP = 4096

# fleets at or below this size always carry the single-candidate rows in
# the joint dispatch (they're near-free there); larger fleets carry them
# only after a noop verdict armed the hint or the bundle is
# mid-transition — a fresh underutilized fleet's first dispatch (which
# almost surely ships a command) skips ~N wasted rows
GLOBAL_SINGLES_MAX = 256


class GlobalConsolidation(Method):
    """Global consolidation: ONE joint device solve over ALL candidates
    proposes the whole retirement set plus its displacement plan, and
    exactly one confirming simulation validates the winning set before
    the command ships (deploy/README.md "Global consolidation").

    The per-candidate ladder below (MultiNode prefix search + SingleNode
    scan) is greedy by construction — each round retires one command's
    worth of nodes and waits for the next generation. Here every prefix
    of the SAME disruption-cost order is a counterfactual row of one
    batched dispatch (ops/consolidate.py ``joint_retirement_plan``), a
    host rounding/repair pass makes the winning row integral, and the
    whole 2k-node underutilized fleet collapses in one command instead of
    a generation-paced descent. The ladder is retired to ORACLE duty:
    topology-compiled bundles, inexpressible shapes, non-definitive
    ladders (the seed under-estimates and needs MultiNode's gallop),
    repair overflows,
    and probe-vs-host confirm disagreements all fall through to it (this
    method returns None and the method order does the rest), so the
    shipped end state is never worse than the reference's. Every
    resolution records one ``consolidate.global`` ledger verdict
    (obs/decisions.py): joint/ok when the set ships, the ladder rung with
    its fallback cause otherwise, sequential when no device solve ran at
    all.
    ``KARPENTER_GLOBAL_CONSOLIDATION=0`` disables the mode (the
    ladder then owns every round, as before the global mode existed)."""

    reason = REASON_UNDERUTILIZED
    needs_validation = True
    is_consolidation = True
    uses_bundle = True  # the controller prewarms the round's snapshot
    decision_site = "consolidate.global"
    last_rung: str = ""  # "joint" | "ladder" | "sequential" (tests + perf)
    last_plan = None  # the round's JointPlan (tests + observability)
    # when True the controller closes the consolidation round after this
    # method returns None: the joint dispatch PROVED round-wide
    # no-retirement (every prefix and every single candidate infeasible,
    # misses definitive) on a mid-transition snapshot — running the
    # MultiNode/SingleNode probes would re-pay dispatches to learn
    # nothing (deploy/README.md "Global consolidation", short-circuit)
    fence_round: bool = False
    # singles hint: armed after the method's FIRST dispatch-bearing round
    # of the process. Every round after a ship or a noop is near-certain
    # to answer no-retirement (the fleet was just consolidated, or
    # already judged packed), and carrying the single rows lets that
    # round seed or fence the whole ladder off its one dispatch — only
    # the cold first solve of a process (the classic underutilized fleet
    # that ships immediately) skips the ~N extra rows
    _singles_armed: bool = False

    def _verdict(self, rung, reason="ok"):
        from karpenter_tpu_torch.obs import decisions

        self.last_rung = rung
        decisions.record_decision("consolidate.global", rung, reason,
                                  registry=self.ctx.registry)

    def compute_command(self, candidates, budgets):
        self.last_plan = None
        self.fence_round = False
        if not _global_enabled():
            self._verdict("sequential", "disabled")
            return None
        pool = _candidate_order(self.ctx, _consolidatable(candidates))
        allowed = within_budget(budgets, self.reason, pool)
        cands = allowed[:_global_cap()]
        # whether the joint dispatch saw EVERY budget-allowed candidate:
        # a cap-truncated view can seed the capped MultiNode question but
        # must never claim round-wide no-retirement (SingleNode's scan is
        # uncapped, and candidates beyond the cap were never examined)
        pool_complete = len(cands) == len(allowed)
        if len(cands) < 2:
            self._verdict("sequential", "too-few-candidates")
            return None
        from karpenter_tpu_torch.models.solver import TorchSolver

        if not isinstance(getattr(self.ctx.provisioner, "solver", None),
                          TorchSolver):
            self._verdict("sequential", "no-device")
            return None
        try:
            from karpenter_tpu_torch.ops.consolidate import joint_retirement_plan

            with obs.span("global.probe", candidates=len(cands)):
                plan = joint_retirement_plan(
                    self.ctx.provisioner, self.ctx.cluster, self.ctx.store,
                    cands,
                    cache=getattr(self.ctx, "snapshot_cache", None),
                    registry=self.ctx.registry,
                    build_candidates=pool,
                    # singles hint: any round after the process's first
                    # dispatch (or on small fleets, where the rows are
                    # near-free) carries the per-candidate rows so the
                    # verdict can seed/fence SingleNode too;
                    # mid-transition bundles force them regardless
                    # (joint_retirement_plan)
                    want_singles=(self._singles_armed
                                  or len(cands) <= GLOBAL_SINGLES_MAX),
                )
        except DEVICE_FAULTS:
            raise
        except Exception:
            import logging

            # _probe_failure records the sequential verdict itself (the
            # shared diagnosis path — counter, anomaly, verdict)
            self.last_rung = "sequential"
            _probe_failure(self.ctx, "global", "consolidate.global")
            logging.getLogger(__name__).warning(
                "device consolidation probe (%s) failed; using the "
                "sequential search", "global", exc_info=True)
            return None
        self.last_plan = plan
        if plan is None:
            self._verdict("sequential", "inexpressible")
            return None
        if plan.prefix_feasible is not None:
            self._singles_armed = True
            # publish the dispatch's answers as the round's seed: the
            # MultiNode/SingleNode probes below answer off it instead of
            # re-paying a device dispatch for the same generation
            from karpenter_tpu_torch.ops.consolidate import JointSeed

            self.ctx.joint_seed = JointSeed(
                plan.generation,
                [c.provider_id for c in cands],
                plan.prefix_feasible,
                plan.definitive,
                plan.single_mask,
            )
        if plan.timings.get("solve_ms") is not None:
            # rows were actually ranked (the dispatch ran — viable or
            # not), mirroring _device_probe's any-non-None stance
            from karpenter_tpu_torch.operator import metrics as m

            self.ctx.registry.histogram(
                m.DISRUPTION_PROBE_BATCH_SIZE,
                "counterfactual rows ranked per batched probe dispatch",
                buckets=m.PROBE_BATCH_BUCKETS,
            ).observe(len(cands), method="global")
        if not plan.viable:
            if (plan.transient and plan.reason == "no-retirement"
                    and plan.definitive and pool_complete
                    and plan.single_mask is not None
                    and not plan.single_mask.any()):
                # provable round-wide noop off the one dispatch, on a
                # MID-TRANSITION snapshot (pending or drain-in-flight
                # pods): every prefix AND every single candidate is
                # infeasible with definitive misses, so the ladder below
                # could only re-learn it — close the round. The next
                # state bump (the wave is still moving) re-probes; a
                # SETTLED fleet's noop verdict deliberately does NOT
                # fence, so the ladder's seeded descent still pays its
                # paranoia confirms against the probe's residual f32
                # false-negative corner — zero extra dispatches either
                # way.
                self._verdict("joint", "joint-noop-fenced")
                self.fence_round = True
                return None
            self._verdict("ladder", plan.reason)
            return None
        cmd = self._confirm(plan.selected)
        if cmd is None or len(cmd.candidates) < 2:
            # probe-vs-host disagreement: the one confirm failed, so the
            # per-candidate ladder (the oracle) decides this round — the
            # shipped command can never differ from the reference's answer
            obs.anomaly("global-confirm-mismatch",
                        registry=self.ctx.registry,
                        selected=len(plan.selected), dropped=plan.dropped)
            self._verdict("ladder", "confirm-mismatch")
            return None
        if plan.displacement:
            # device-side rebinding lever (fused cluster round): hand the
            # displacement plan's survivor targets to the binder so the
            # post-command eviction wave re-binds hint-first instead of
            # cold-scanning the fleet (kube/binder.py seed_wave_hints)
            from karpenter_tpu_torch.kube import binder as _binder

            name_of = {n.provider_id: n.name
                       for n in self.ctx.store.list("nodes")
                       if n.provider_id}
            _binder.seed_wave_hints(
                (name_of[pid], take)
                for pid, _g, take in plan.displacement
                if pid in name_of and take > 0)
        if getattr(plan, "solver", "ladder") == "relax":
            # the LP relaxation rung selected the set (ops/relax.py):
            # relax = rounded at the LP bound, relax-rounded = the
            # window shed candidates below it
            self._verdict("joint",
                          "relax" if plan.dropped == 0 else "relax-rounded")
        elif getattr(plan, "relax_fallback", False):
            # the relax rung attempted and declined, the FFD ladder
            # shipped — a command all the same, but the descent is
            # visible (RELAX_STATS carries the cause)
            self._verdict("joint", "relax-fallback")
        elif getattr(plan, "n_claims", 1) > 1:
            # the joint REPLACE program opened multiple fresh claims for
            # one retirement set (KARPENTER_REPLACE_MAX_CLAIMS > 1) — a
            # shape the m->1 delete-row rule would have stranded
            self._verdict("joint", "replace")
        else:
            self._verdict("joint")
        return cmd

    def _confirm(self, selected):
        """The round's ONE real simulation of the joint set — the shared
        :func:`confirm_consolidation` contract, identical to the one the
        MultiNode prefix pays."""
        return confirm_consolidation(self.ctx, selected, "global",
                                     selected=len(selected))


class MultiNodeConsolidation(Method):
    """Largest N where candidates[0..N] collapse into ≤1 replacement
    (disruption/multinodeconsolidation.go:47-163). The prefix search runs
    as ONE batched device probe (ops/consolidate.py) — all N prefixes
    evaluated in a single vmapped pack call — and when the probe declares
    its ladder DEFINITIVE (plan-free, claim accounting provably mirroring
    the simulation's: every modeled host check can only over-estimate)
    the single winning prefix pays the round's only confirming simulation
    and ships. Probe-vs-host disagreement (the confirm at k fails) falls
    back to the reference's sequential binary search below k.
    Non-definitive ladders (topology-compiled bundles, batches too large
    to prove claimability for) keep the upward gallop step around k, so
    the chosen command matches the reference's there at the reference's
    cost; scenarios the probe can't express at all fall back to the full
    sequential search. The whole
    search is bounded by a 1-minute wall clock (multinodeconsolidation.go
    :37): on timeout the best command found so far is returned rather than
    searching unbounded."""

    reason = REASON_UNDERUTILIZED
    needs_validation = True
    is_consolidation = True
    uses_bundle = True
    # "device" | "seeded" | "sequential" (observability + tests) —
    # "seeded" means the answer came from the round's joint dispatch
    # (JointSeed) without paying a second device dispatch
    last_probe: str = ""
    last_host_confirms: int = 0  # host simulations this round (tests + perf)
    _seeded: bool = False

    def compute_command(self, candidates, budgets):
        # reset BEFORE the search: an early return inside _compute (fewer
        # than 2 candidates) must not leave last round's counter behind to
        # fire a spurious anomaly on a quiet round
        self.last_host_confirms = 0
        self.last_probe = ""
        self._seeded = False
        cmd = self._compute(candidates, budgets)
        if self.last_host_confirms > 1:
            # anomaly trigger: the batched confirm ladder targets exactly
            # one host simulation per round — more means probe-vs-host
            # disagreement or a non-definitive ladder, and the round's
            # trace shows which confirm burned the time
            obs.anomaly(
                "multi-host-confirms", registry=self.ctx.registry,
                confirms=self.last_host_confirms, probe=self.last_probe,
            )
        return cmd

    def _compute(self, candidates, budgets):
        pool = _candidate_order(self.ctx, _consolidatable(candidates))
        cands = within_budget(budgets, self.reason, pool)[:MULTI_NODE_CANDIDATE_CAP]
        if len(cands) < 2:
            return None
        self._deadline = self.ctx.clock.now() + MULTI_NODE_TIMEOUT

        probed = self._probe(cands, pool)
        if probed is not None:
            k, definitive = probed
            self.last_probe = "seeded" if self._seeded else "device"
            # the round's probe.confirm verdict (obs/decisions.py): a
            # definitive ladder pays ONE confirming simulation; a
            # non-definitive one keeps the gallop/search around the seed.
            # Seeded answers (the joint dispatch already ranked these
            # prefixes this generation — no second dispatch) carry the
            # joint-seeded reason so the skipped-probe path is accounted,
            # never silent. The sequential rungs were recorded by
            # _device_probe.
            from karpenter_tpu_torch.obs import decisions

            decisions.record_decision(
                "probe.confirm",
                "definitive" if definitive else "gallop",
                ("joint-seeded" if self._seeded
                 else "ok" if definitive else "non-definitive"),
                registry=self.ctx.registry)
            if k < 2:
                # paranoia confirm of the smallest prefix guards the
                # probe's residual false-negative corner (f32 rounding);
                # if it lands, the probe misjudged the batch and the
                # reference's full search takes over
                cmd = self._confirm(cands[:2])
                if cmd is None:
                    return None  # probe confirmed: nothing consolidates
                return self._binary_search(cands, hi=len(cands), lo=3, best=cmd)
            cmd = self._confirm(cands[:k])
            if cmd is not None and len(cmd.candidates) >= 2:
                if definitive or k >= len(cands):
                    # the ladder already proved every prefix above k
                    # infeasible (definitive misses only over-estimate):
                    # this confirm was the round's ONLY host solve
                    return cmd
                # non-definitive ladder: k is a seed, not an answer — one
                # upward gallop step, then resume the search above it
                up = self._confirm(cands[: k + 1])
                if up is not None:
                    return self._binary_search(
                        cands, hi=len(cands), lo=k + 2, best=up
                    )
                return cmd
            # probe-vs-host disagreement (price filter / validation detail
            # the kernel doesn't model): the reference's search below k
            # decides, so the shipped command never differs from its answer
            return self._binary_search(cands, hi=k - 1)
        self.last_probe = "sequential"
        return self._binary_search(cands, hi=len(cands))

    def _probe(self, cands, pool=None):
        from karpenter_tpu_torch.ops.consolidate import batched_feasible_prefix

        seeded = _seed_answer(self.ctx, cands, "prefix")
        if seeded is not None:
            self._seeded = True
            return seeded
        return _device_probe(self.ctx, batched_feasible_prefix, "multi",
                             cands, pool)

    def _confirm(self, prefix):
        """One real simulation of a candidate prefix (the shared
        :func:`confirm_consolidation` contract) with this method's
        host-confirm streak accounting on top."""
        self.last_host_confirms += 1
        return confirm_consolidation(self.ctx, prefix, "multi",
                                     prefix=len(prefix))

    def _timed_out(self) -> bool:
        return _search_timed_out(self.ctx, self._deadline, "multi")

    def _binary_search(self, cands, hi, lo=1, best=None):
        # binary search on prefix length (multinodeconsolidation.go:111-163),
        # returning the best-so-far command when the 1-min budget expires
        # (:124-135)
        while lo <= hi:
            if self._timed_out():
                break
            mid = (lo + hi) // 2
            cmd = self._confirm(cands[:mid])
            if cmd is not None:
                best = cmd
                lo = mid + 1
            else:
                hi = mid - 1
        if best is not None and len(best.candidates) < 2:
            return None  # single-node results belong to SingleNodeConsolidation
        return best


class SingleNodeConsolidation(Method):
    """One-candidate-at-a-time consolidation, abandoned after a 3-minute
    wall clock (disruption/singlenodeconsolidation.go:46-120).

    The reference's linear scan — a full scheduling simulation per
    candidate — runs here as ONE batched device probe
    (ops/consolidate.py batched_single_feasible): every candidate's
    counterfactual is ranked in a single vmapped pack dispatch over the
    round's shared snapshot, and only probe HITS get the real confirming
    simulation (price filter, validation). The probe is a seed, not the
    decision: a confirming hit back-checks every cheaper probe miss before
    shipping (so a false negative can never disrupt a costlier node than
    the reference's lowest-cost-first scan would), and whenever NO hit
    confirms, one paranoia confirmation runs on the cheapest miss (the
    mirror of MultiNode's k<2 confirm) — if it lands, the probe misjudged
    the batch and the method degenerates into the reference's sequential
    scan; if it fails, the probe's negative answer stands for this round
    (the next state change re-probes). Inexpressible scenarios skip the
    probe entirely and run the sequential scan."""

    reason = REASON_UNDERUTILIZED
    needs_validation = True
    is_consolidation = True
    uses_bundle = True
    # "device" | "seeded" | "sequential" (observability + tests)
    last_probe: str = ""
    _seeded: bool = False

    def compute_command(self, candidates, budgets):
        self._seeded = False
        pool = _candidate_order(self.ctx, _consolidatable(candidates))
        cands = within_budget(budgets, self.reason, pool)
        if not cands:
            return None
        deadline = self.ctx.clock.now() + SINGLE_NODE_TIMEOUT
        probed = self._probe(cands, pool)
        if probed is None:
            self.last_probe = "sequential"
            res = self._scan(cands, deadline)
            return None if res is _TIMED_OUT else res
        feas, definitive = probed
        self.last_probe = "seeded" if self._seeded else "device"
        # one probe.confirm verdict per ladder descent, mirroring
        # MultiNode's (sequential rungs recorded by _device_probe;
        # joint-seeded answers paid no dispatch of their own)
        from karpenter_tpu_torch.obs import decisions

        decisions.record_decision(
            "probe.confirm",
            "definitive" if definitive else "gallop",
            ("joint-seeded" if self._seeded
             else "ok" if definitive else "non-definitive"),
            registry=self.ctx.registry)
        # confirm hits in disruption-cost order; probe misses are only
        # SKIPPED, never discarded: when a hit confirms, any miss that
        # precedes it is back-checked first so a probe false negative can
        # never make the method ship a costlier node than the reference's
        # lowest-cost-first scan would (the result is exactly the first
        # candidate — in order — that the exact simulation accepts, up to
        # and including the first confirming hit)
        any_hit = False
        skipped: list = []
        for c, ok in zip(cands, feas):
            if not ok:
                skipped.append(c)
                continue
            any_hit = True
            if self._timed_out(deadline):
                return None  # abandon mid-scan (:71-75)
            cmd = self._confirm_one(c)
            if cmd is None:
                continue
            earlier = self._scan(skipped, deadline)
            if earlier is _TIMED_OUT:
                # an exhausted budget mid-back-check means the cheaper
                # misses were NEVER cleared: shipping the later hit would
                # disrupt a costlier node than the reference's lowest-cost-
                # first scan ever could — abandon, like the reference does
                return None
            return earlier if earlier is not None else cmd
        if skipped:
            if not definitive:
                # topology bundle: misses are hints, not answers (the waves
                # counterfactual can tighten the probe) — finish with the
                # reference's scan so no consolidation is silently skipped
                res = self._scan(skipped, deadline)
                return None if res is _TIMED_OUT else res
            # no hit confirmed: one paranoia simulation of the cheapest
            # skipped miss guards the definitive probe's residual
            # false-negative corner (f32 fit rounding); if it lands the
            # probe misjudged the batch
            if self._timed_out(deadline):
                return None
            cmd = self._confirm_one(skipped[0])
            if cmd is not None:
                return cmd
            if any_hit and skipped[1:]:
                # hits existed but ALL confirms failed — the probe is
                # demonstrably misaligned with the exact checks this round,
                # so finish with the reference's scan rather than skipping
                res = self._scan(skipped[1:], deadline)
                return None if res is _TIMED_OUT else res
        return None

    def _scan(self, cands, deadline):
        """The reference's linear scan (singlenodeconsolidation.go:64-89).
        Returns the first confirmed command, None when every candidate was
        exhausted, or _TIMED_OUT when the wall clock expired mid-scan — the
        back-check caller must distinguish 'cleared' from 'never checked'."""
        for c in cands:
            if self._timed_out(deadline):
                return _TIMED_OUT  # abandon mid-scan (:71-75)
            cmd = self._confirm_one(c)
            if cmd is not None:
                return cmd
        return None

    def _confirm_one(self, c):
        """One real simulation of a single candidate, with host-confirm
        accounting (the perf harness's `host_confirm_count`)."""
        from karpenter_tpu_torch.operator import metrics as m

        self.ctx.registry.counter(
            m.DISRUPTION_HOST_CONFIRMS,
            "confirming host simulations run by consolidation methods",
        ).inc(method="single")
        with obs.span("confirm.simulate", method="single"), \
                self.ctx.registry.measure(m.DISRUPTION_CONFIRM_DURATION,
                                          method="single"):
            return compute_consolidation(self.ctx, [c])

    def _timed_out(self, deadline) -> bool:
        return _search_timed_out(self.ctx, deadline, "single")

    def _probe(self, cands, pool=None):
        from karpenter_tpu_torch.ops.consolidate import batched_single_feasible

        seeded = _seed_answer(self.ctx, cands, "single")
        if seeded is not None:
            self._seeded = True
            return seeded
        return _device_probe(self.ctx, batched_single_feasible, "single",
                             cands, pool)
