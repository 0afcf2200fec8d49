"""ChaosCloud: the ONE seeded fault injector behind the CloudProvider seam.

Grown out of tests/test_chaos.py's private ICE wrapper when spot
resilience (deploy/README.md "Spot resilience") needed the same storm in
three places — the chaos convergence suite, the spot-resilience tests, and
``python -m perf spot``'s 1000-node acceptance storm. One implementation,
not three drifting copies:

* **ICE injection** — a seeded fraction of ``create`` calls raise
  :class:`~karpenter_tpu_torch.cloudprovider.types.InsufficientCapacityError`
  (the fake-provider fault-injection pattern, fake/cloudprovider.go:54-58);
  ``force_first_ice`` makes every seed exercise the terminal-ICE recovery
  path at least once.
* **Offering flaps** — seeded availability toggles (spot market churn).
* **Price shifts** — risk-correlated spot price drift: the storm multiplies
  high-risk offerings' prices upward, the real-market coupling (capacity
  pressure raises both the reclaim rate and the clearing price) the
  risk-discounted effective price exists to anticipate.
* **Interruption notices** — seeded two-minute-warning injection: live
  spot nodes are sampled ∝ their offering's ``interruption_risk`` and a
  notice with a deadline lands on the provider's
  ``interruption_notices()`` feed (the disruption controller drains it).
* **Reclaim** — at the deadline the capacity VANISHES ungracefully (node,
  claim, and bound pods deleted; no drain): whatever was still bound is
  counted ``pods_lost`` — and ``pods_lost_with_lead`` when the notice had
  arrived with real lead time, the number the spot acceptance pins at
  ZERO (a proactive drain must have emptied the node first).

``arm(env)`` patches the environment's (wrapped) provider in place —
instance-attribute overrides on the live object every controller already
holds — so it composes with MetricsCloudProvider and needs no wiring
changes.

The port's copy of ``karpenter_tpu/cloudprovider/chaos.py`` (imports
changed). Every draw comes from the caller's seeded ``random.Random``, in
the JAX package's order, so one seed storms both packages alike.
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.cloudprovider.types import (
    CatalogView,
    InsufficientCapacityError,
    InterruptionNotice,
)


class ChaosCloud:
    def __init__(self, rng, ice_rate: float = 0.0,
                 force_first_ice: bool = False):
        self.rng = rng
        self.ice_rate = ice_rate
        self.force_first_ice = force_first_ice
        self.active = True
        self.env = None
        self._pending: list = []  # InterruptionNotice not yet pulled
        # provider_id -> (deadline, counts_as_early)
        self._deadlines: dict = {}
        self.stats = {
            "ices": 0,
            "flaps": 0,
            "price_shifts": 0,
            "notices": 0,
            "reclaims": 0,
            "pods_lost": 0,
            "pods_lost_with_lead": 0,
        }

    # test_chaos.py's historical surface
    @property
    def ices(self) -> int:
        return self.stats["ices"]

    # -- wiring -----------------------------------------------------------

    def arm(self, env) -> "ChaosCloud":
        """Attach to an Environment: wrap ``create`` with seeded ICEs and
        feed ``interruption_notices`` from this injector. Patches the
        instance every controller already references, so arming after
        Environment construction is safe."""
        self.env = env
        inner_create = env.cloud.create

        def create(nc):
            if self.active and self.ice_rate > 0 and (
                (self.force_first_ice and self.stats["ices"] == 0)
                or self.rng.random() < self.ice_rate
            ):
                self.stats["ices"] += 1
                raise InsufficientCapacityError(
                    f"chaos ICE #{self.stats['ices']}")
            return inner_create(nc)

        env.cloud.create = create
        env.cloud.interruption_notices = self.take_notices
        return self

    def take_notices(self) -> list:
        out, self._pending = self._pending, []
        return out

    def has_notice(self, provider_id: str) -> bool:
        """Whether a (not-yet-reclaimed) notice already targets this
        node — injectors must check it: a second notice would silently
        OVERWRITE the first one's deadline and early-flag, corrupting the
        zero-late-drain accounting the acceptance gates on."""
        return provider_id in self._deadlines

    # -- storm actions ----------------------------------------------------

    def flap_random_offering(self, offerings):
        """Toggle one offering's availability (ICE or recovery)."""
        o = self.rng.choice(list(offerings))
        o.available = not o.available
        self.stats["flaps"] += 1
        return o

    def shift_prices(self, offerings, factor: float = 1.2,
                     min_risk: float = 0.5) -> int:
        """Risk-correlated spot price drift: every spot offering whose
        risk is at or above ``min_risk`` gets its price multiplied by
        ``factor`` — the capacity-pressure spiral the storm models. The
        type-side tensor cache fingerprints offering prices, so in-place
        drift invalidates cleanly."""
        shifted = 0
        for o in offerings:
            if (o.capacity_type == wk.CAPACITY_TYPE_SPOT
                    and (o.interruption_risk or 0.0) >= min_risk):
                o.price = round(o.price * factor, 6)
                shifted += 1
        self.stats["price_shifts"] += shifted
        return shifted

    def inject_notice(self, provider_id: str, deadline: float,
                      early: bool = True):
        """Queue one interruption notice. ``early`` marks whether the
        notice carries ≥1 round of lead time — pods lost at its reclaim
        then count against the zero-late-drain acceptance."""
        self._pending.append(InterruptionNotice(provider_id, deadline))
        self._deadlines[provider_id] = (deadline, bool(early))
        self.stats["notices"] += 1

    def notice_storm(self, rate: float, lead_s: float,
                     early: bool = True) -> int:
        """Sample live spot nodes ∝ offering risk and notice them with a
        ``lead_s``-second deadline. ``rate`` scales the per-node draw
        (node risk × rate), so a low-risk fleet rides out the same storm
        a high-risk fleet churns through — the spot acceptance's entire
        mechanism."""
        if self.env is None:
            return 0
        now = self.env.clock.now()
        risks = self._node_risks()
        issued = 0
        for node, risk in risks:
            if node.provider_id in self._deadlines:
                continue  # already noticed
            if self.rng.random() < rate * risk:
                self.inject_notice(node.provider_id, now + lead_s,
                                   early=early)
                issued += 1
        return issued

    def _node_risks(self):
        """[(node, risk)] for live spot nodes, risk from the node's
        (instance-type, zone) offering via the shared resolution walk
        (types.CatalogView)."""
        env = self.env
        view = CatalogView(env.store.list("nodepools"), env.cloud)
        out = []
        for node in env.store.list("nodes"):
            if node.metadata.deletion_timestamp is not None:
                continue
            labels = node.labels
            if labels.get(wk.CAPACITY_TYPE_LABEL) != wk.CAPACITY_TYPE_SPOT:
                continue
            o = view.offering(labels)
            if o is None:
                continue
            out.append((node, o.interruption_risk or 0.0))
        return out

    # -- the reclaim ------------------------------------------------------

    def reclaim_expired(self) -> int:
        """Kill every noticed node whose deadline passed and is still
        alive: the capacity vanishes UNGRACEFULLY — bound pods die with
        it (``pods_lost``; ``pods_lost_with_lead`` when the notice had
        real lead — the proactive drain should have emptied the node
        long before this fires). A node already gone (the proactive path
        worked) just clears its bookkeeping."""
        env = self.env
        now = env.clock.now()
        reclaimed = 0
        for pid, (deadline, early) in list(self._deadlines.items()):
            if now < deadline:
                continue
            del self._deadlines[pid]
            node = next(
                (n for n in env.store.list("nodes")
                 if n.provider_id == pid), None)
            if node is None:
                continue  # drained and gone before the deadline
            reclaimed += 1
            self.stats["reclaims"] += 1
            bound = [
                p for p in env.store.list("pods")
                if p.node_name == node.metadata.name
                and p.metadata.deletion_timestamp is None
            ]
            self.stats["pods_lost"] += len(bound)
            if early:
                self.stats["pods_lost_with_lead"] += len(bound)
            for p in bound:
                p.metadata.finalizers = []
                env.store.delete("pods", p)
            # the instance is gone: force-release node and claim (no
            # graceful finalizer path — that is the entire point)
            node.metadata.finalizers = []
            env.store.delete("nodes", node)
            claim = next(
                (c for c in env.store.list("nodeclaims")
                 if c.status.provider_id == pid), None)
            if claim is not None:
                claim.metadata.finalizers = []
                env.store.delete("nodeclaims", claim)
            created = getattr(env.cloud, "created", None)
            if isinstance(created, dict):
                created.pop(pid, None)
        return reclaimed
