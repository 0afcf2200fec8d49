"""Operator runtime: wires the store, provider, and controller ring.

This is both the production wiring (the analog of the reference's
kwok/main.go:33-48 + operator.NewOperator, operator.go:111) and the test
harness (the envtest analog, pkg/test/environment.go): controllers are
driven synchronously by draining store events until the system quiesces,
exactly how the reference suites drive reconcilers with
ExpectSingletonReconciled (expectations.go:174).

The port's copy of ``karpenter_tpu/operator/environment.py`` (imports
changed): the same controller ring in the same order. ``solver=None``
means ``TorchSolver()``, which runs on CUDA and raises without a card;
pass ``solver=TorchSolver(device="cpu")`` for the plain PyTorch path.
"""

from __future__ import annotations

from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
from karpenter_tpu_torch.controllers.nodeclaim.lifecycle import NodeClaimLifecycleController
from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner
from karpenter_tpu_torch.kube import Binder, KubeStore
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.utils.clock import FakeClock


class Environment:
    def __init__(
        self,
        instance_types=None,
        clock=None,
        cloud=None,
        solver=None,
        sync: bool = True,
        enable_disruption: bool = False,
        disruption_options: dict | None = None,
        validation_ttl: float | None = None,
        provider_metrics: bool = True,
        options=None,
        store=None,  # share an apiserver across instances (HA/standby)
        log=None,  # structured Logger; tests default to NOP (quiet)
    ):
        from karpenter_tpu_torch.cloudprovider.metrics import MetricsCloudProvider
        from karpenter_tpu_torch.controllers.provisioning.batcher import Batcher
        from karpenter_tpu_torch.operator.events import Recorder
        from karpenter_tpu_torch.operator.logging import NOP
        from karpenter_tpu_torch.operator.metrics import Registry
        from karpenter_tpu_torch.operator.options import Options

        self.options = options or Options.from_env()
        self.log = log if log is not None else NOP
        self.clock = clock or FakeClock()
        self.store = store or KubeStore(self.clock)
        self.recorder = Recorder(clock=self.clock)
        # per-environment registry: two Environments in one process (the
        # pytest norm) must not clobber each other's gauge sweeps
        self.registry = Registry()
        self.cloud = cloud or KwokCloudProvider(self.store, instance_types)
        if provider_metrics and not isinstance(self.cloud, MetricsCloudProvider):
            self.cloud = MetricsCloudProvider(self.cloud, registry=self.registry)
        self.binder = Binder(self.store, clock=self.clock, registry=self.registry)
        self.cluster = Cluster(self.store, clock=self.clock)
        # leader election gates every reconcile round (operator.go
        # LeaderElection): a single-instance environment always holds the
        # lease; a standby Environment sharing the store stays passive
        import uuid

        from karpenter_tpu_torch.operator.leaderelection import LeaderElector

        # identity must be unique per INSTANCE lifetime: id(self) is reused
        # after GC, which would let a new instance inherit a dead leader's
        # lease and skip the takeover resync
        self.elector = LeaderElector(
            self.store, identity=f"karpenter-{uuid.uuid4().hex[:12]}",
            clock=self.clock,
        )
        # sync mode collapses the batch window so tests drive deterministically
        batcher = (
            Batcher(self.clock, idle_duration=0.0, max_duration=0.0)
            if sync
            else Batcher(
                self.clock,
                idle_duration=self.options.batch_idle_duration,
                max_duration=self.options.batch_max_duration,
            )
        )
        self.provisioner = Provisioner(
            self.store,
            self.cloud,
            solver=solver,
            clock=self.clock,
            batcher=batcher,
            cluster=self.cluster,
            recorder=self.recorder,
            registry=self.registry,
            log=self.log.with_values(controller="provisioner"),
        )
        from karpenter_tpu_torch.controllers.disruption import DisruptionController
        from karpenter_tpu_torch.controllers.node.leasegc import LeaseGarbageCollectionController
        from karpenter_tpu_torch.controllers.node.termination import NodeTerminationController
        from karpenter_tpu_torch.controllers.nodeclaim.consistency import (
            NodeClaimConsistencyController,
        )
        from karpenter_tpu_torch.controllers.nodeclaim.disruption import (
            NodeClaimDisruptionController,
        )
        from karpenter_tpu_torch.controllers.nodeclaim.garbagecollection import (
            NodeClaimGarbageCollectionController,
        )
        from karpenter_tpu_torch.controllers.nodepool.counter import NodePoolCounterController
        from karpenter_tpu_torch.controllers.nodepool.hash import NodePoolHashController
        from karpenter_tpu_torch.controllers.nodepool.readiness import (
            NodePoolReadinessController,
        )
        from karpenter_tpu_torch.controllers.nodepool.validation import (
            NodePoolValidationController,
        )
        from karpenter_tpu_torch.controllers.metrics import (
            NodeMetricsController,
            NodePoolMetricsController,
            PodMetricsController,
        )
        from karpenter_tpu_torch.kube.daemonset import DaemonSetController
        from karpenter_tpu_torch.kube.workload import WorkloadController

        self.controllers = [
            NodePoolHashController(self.store),
            NodePoolValidationController(self.store, recorder=self.recorder),
            NodePoolReadinessController(self.store),
            NodePoolCounterController(self.store),
            NodeClaimLifecycleController(
                self.store, self.cloud, clock=self.clock, recorder=self.recorder,
                registry=self.registry,
            ),
            NodeClaimDisruptionController(
                self.store, self.cloud, self.cluster, clock=self.clock,
                registry=self.registry,
            ),
            NodeClaimGarbageCollectionController(
                self.store, self.cloud, clock=self.clock, recorder=self.recorder
            ),
            NodeClaimConsistencyController(
                self.store, clock=self.clock, recorder=self.recorder
            ),
            NodeTerminationController(
                self.store, clock=self.clock, recorder=self.recorder,
                registry=self.registry,
            ),
            LeaseGarbageCollectionController(self.store, recorder=self.recorder),
            DaemonSetController(self.store),
            WorkloadController(self.store),
            NodeMetricsController(self.store, registry=self.registry),
            PodMetricsController(self.store, registry=self.registry),
            NodePoolMetricsController(self.store, registry=self.registry),
        ]
        self.disruption = None
        if enable_disruption:
            self.disruption = DisruptionController(
                self.store,
                self.cluster,
                self.cloud,
                self.provisioner,
                clock=self.clock,
                recorder=self.recorder,
                # feature gates feed the method ladder (spot_to_spot gate,
                # consolidation.go:214); explicit disruption_options win
                options={**self.options.feature_gates, **(disruption_options or {})},
                poll_period=0.0 if sync else 10.0,
                validation_ttl=(
                    validation_ttl if validation_ttl is not None else (0.0 if sync else 15.0)
                ),
                registry=self.registry,
                log=self.log.with_values(controller="disruption"),
            )
            self.controllers.append(self.disruption)

    def _round(self, rng=None) -> bool:
        """One reconcile round: informer-first event dispatch, then the
        poll sources (provisioner, controllers, binder). `rng` randomizes
        the poll ORDER (deflake mode); event dispatch stays informer-first
        because state must mirror an event before any controller acts on
        it (state/informer/*)."""
        was_leader = self.elector.is_leader()
        leading = self.elector.try_acquire()
        if leading and not was_leader and self.elector.last_acquire_takeover:
            # takeover: warm the informer cache from the store snapshot —
            # the hermetic store's event queue is single-consumer, so a
            # standby has not seen the events the old leader drained — and
            # arm the batcher: pod events the old leader consumed but never
            # finished reconciling must not strand pending pods. Renewing
            # our OWN stale lease (clock jumped past the duration with no
            # contender) is NOT a takeover: the holder never changed, so
            # nobody else drained events and the informer state is
            # continuous — resyncing there would journal an opaque
            # consolidation bump (and rebuild every cached snapshot) each
            # time the clock outruns the lease
            self.cluster.resync()
            self.provisioner.trigger()
        if not leading:
            return False  # standby: hold position until the lease frees
        progressed = False
        for event in self.store.drain_events():
            self.cluster.on_event(event)
            self.provisioner.on_event(event)
            for c in self.controllers:
                c.on_event(event)
            # the elector's own renewals are bookkeeping, not work: they
            # must not hold the loop out of idle (one spurious full round
            # per renewal otherwise)
            if not (event.kind == "leases"
                    and getattr(event.obj.metadata, "namespace", "") == "kube-system"):
                progressed = True
        sources = [self.provisioner.reconcile]
        sources += [c.poll for c in self.controllers]
        sources.append(self.binder.bind_pending)
        if rng is not None:
            rng.shuffle(sources)
        for poll in sources:
            if poll():
                progressed = True
        return progressed

    def run_until_idle(self, max_rounds: int = 100) -> int:
        """Drain events and reconcile until nothing changes; returns rounds."""
        rounds = 0
        for rounds in range(1, max_rounds + 1):
            if not self._round():
                break
        return rounds

    def run_until_idle_shuffled(self, rng, max_rounds: int = 100) -> int:
        """Deflake mode — the -race/flake-attempts analog (SURVEY.md §5):
        the poll order is re-randomized every round, surfacing
        order-dependent bugs the fixed reconcile order would mask. The
        Go reference gets interleaving variance from the scheduler for
        free; a single-threaded runtime has to inject it. Invariants must
        hold under EVERY ordering (tests/test_deflake.py sweeps seeds)."""
        rounds = 0
        for rounds in range(1, max_rounds + 1):
            if not self._round(rng=rng):
                break
        return rounds

    # -- convenience -----------------------------------------------------
    def create(self, kind: str, *objs):
        for obj in objs:
            self.store.create(kind, obj)
        return objs[0] if len(objs) == 1 else objs

    def provision(self, *pods):
        """Create pods → run to quiescence (the ExpectProvisioned analog)."""
        for p in pods:
            self.store.create("pods", p)
        self.run_until_idle()
        return pods
