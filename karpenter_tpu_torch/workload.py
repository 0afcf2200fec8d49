"""The port's workloads, built from its own objects.

- **headline** (``build_workload``, the copy of ``bench.py``'s): ``n_pods``
  pending pods in 24 deployment shapes (six cpu/memory sizes × four
  selectors: none, amd64, arm64, spot), two NodePools (``general``, and
  ``spot`` at weight 10) and ``benchmark_catalog(n_types)``. The headline
  is 50,000 pods × 500 types on an empty cluster.
- **live round** (``live_cluster`` + ``live_round``): the headline's
  claims launched as a running cluster — one node per claim, on the
  instance type and offering the kwok provider would launch — and a burst
  of the upstream scheduling benchmark's 1/6 constraint mix
  (``diverse_pods``, the copy of ``perf/configs.py``'s) provisioned onto
  it, with a real ``Topology`` and every node an ``ExistingNode``. At
  full size: 1,128 nodes and 5,000 pods (seed 42).
- **underutilized fleet** (``underutilized_fleet``): the end state of the
  consolidation configs written into a store directly, for the probe's
  entry points.
- **operator fleet** (``consolidation_env``): the same fleet built through
  the port's ``Environment`` — deployments, provisioning, binding and the
  scale-down — with the disruption controller armed, for the operator
  loop.
- **admission grid** (``priority_mix``, ``gang_mix``, ``preempt_env``):
  the copies of ``perf/configs.py``'s admission families — a seeded burst
  over three priority tiers, loose pods plus 20 pod-groups (one starved),
  and a limit-capped fleet of low-priority replicas a high-priority burst
  can only enter by preemption.
- **spot storm** (``spot_catalog``, ``spot_env``): the copy of
  ``perf/configs.py``'s spot-pinned fleet at full utilization, on one
  16-cpu type whose spot offerings anti-correlate price and interruption
  risk across four zones, for ``ChaosCloud``'s storms.
- **multi-tenant fleet** (``run_multitenant``): the copy of
  ``perf/run.py``'s ``run_multitenant`` — N concurrent synthetic clusters
  (8 tenants × 3 rounds × 40 pods over ``benchmark_catalog(40)``, one
  default NodePool) reconciling through ONE solver service started as
  its own process (coalescing window 4 ms), in session mode with
  streaming deltas, each tenant's claims diffed against its solo
  in-process oracle.

Every function here keeps the JAX package's sizes, seeds and draw order.
"""

from __future__ import annotations

from contextlib import contextmanager

GIB = 2**30


def build_workload(n_pods=50_000, n_types=500):
    """(pods, templates, instance_types_by_pool) for one burst."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.nodepool import NodePool
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_tpu_torch.cloudprovider.catalog import benchmark_catalog
    from karpenter_tpu_torch.models.inflight import ClaimTemplate

    catalog = benchmark_catalog(n_types)
    pools = [NodePool(metadata=ObjectMeta(name="general"))]
    spot = NodePool(metadata=ObjectMeta(name="spot"))
    spot.spec.weight = 10
    pools.append(spot)

    shapes = []
    sizes = [(0.1, 0.25), (0.25, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 8.0), (4.0, 16.0)]
    selectors = [
        {},
        {wk.ARCH_LABEL: "amd64"},
        {wk.ARCH_LABEL: "arm64"},
        {wk.CAPACITY_TYPE_LABEL: "spot"},
    ]
    for cpu, mem in sizes:
        for sel in selectors:
            shapes.append(({"cpu": cpu, "memory": mem * GIB}, sel))

    pods = []
    for i in range(n_pods):
        req, sel = shapes[i % len(shapes)]
        # spec sub-objects shared by reference, like clone-stamped replicas
        pods.append(
            Pod(metadata=ObjectMeta(name=f"p{i}"), requests=req, node_selector=sel)
        )
    templates = [ClaimTemplate(p) for p in pools]
    its = {p.name: catalog for p in pools}
    return pods, templates, its


def _pod(name, cpu, mem_gib, **kw):
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod

    return Pod(
        metadata=ObjectMeta(name=name, labels=kw.pop("labels", {})),
        requests={"cpu": cpu, "memory": mem_gib * GIB},
        **kw,
    )


def diverse_pods(count: int, seed: int = 42):
    """The reference benchmark's 1/6 constraint mix, faithfully randomized
    (scheduling_benchmark_test.go makeDiversePods:234-248 + the seeded
    generators :250-363): per-pod random labels over 7 values, random
    cpu/memory from the reference's menus, spread selectors drawn
    independently of the pod's own labels (cross-group counting), affinity
    selectors likewise (cross-group chains), and a single shared
    anti-affinity cohort (app=nginx, one pod per hostname). The copy of
    ``perf/configs.py``'s ``diverse_pods``: same seed, same pods."""
    import random

    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.objects import (
        Affinity,
        LabelSelector,
        PodAffinity,
        PodAffinityTerm,
        TopologySpreadConstraint,
    )

    r = random.Random(seed)
    VALUES = ("a", "b", "c", "d", "e", "f", "g")
    CPUS = (0.1, 0.25, 0.5, 1.0, 1.5)  # randomCPU():376 (millicores)
    MEMS = (100, 256, 512, 1024, 2048, 4096)  # randomMemory():371 (Mi)

    def rnd_requests():
        return r.choice(CPUS), r.choice(MEMS) / 1024.0

    def rnd_labels():
        return {"my-label": r.choice(VALUES)}

    def rnd_aff_labels():
        return {"my-affininity": r.choice(VALUES)}  # [sic], the ref's typo

    pods = []

    def generic(n, tag):
        for i in range(n):
            cpu, mem = rnd_requests()
            pods.append(_pod(f"g{tag}-{i}", cpu, mem, labels=rnd_labels()))

    def spread(n, key, tag):
        for i in range(n):
            cpu, mem = rnd_requests()
            pods.append(_pod(
                f"s{tag}-{i}", cpu, mem, labels=rnd_labels(),
                topology_spread_constraints=[TopologySpreadConstraint(
                    max_skew=1, topology_key=key, when_unsatisfiable="DoNotSchedule",
                    label_selector=LabelSelector(match_labels=rnd_labels()))]))

    def affinity(n, key, tag):
        for i in range(n):
            cpu, mem = rnd_requests()
            pods.append(_pod(
                f"a{tag}-{i}", cpu, mem, labels=rnd_aff_labels(),
                affinity=Affinity(pod_affinity=PodAffinity(required=[
                    PodAffinityTerm(topology_key=key,
                                    label_selector=LabelSelector(
                                        match_labels=rnd_aff_labels()))]))))

    def anti(n, key, tag):
        labels = {"app": "nginx"}
        for i in range(n):
            cpu, mem = rnd_requests()
            pods.append(_pod(
                f"x{tag}-{i}", cpu, mem, labels=dict(labels),
                affinity=Affinity(pod_anti_affinity=PodAffinity(required=[
                    PodAffinityTerm(topology_key=key,
                                    label_selector=LabelSelector(
                                        match_labels=dict(labels)))]))))

    sixth = count // 6
    generic(sixth, "0")
    spread(sixth, wk.TOPOLOGY_ZONE_LABEL, "z")
    spread(sixth, wk.HOSTNAME_LABEL, "h")
    affinity(sixth, wk.HOSTNAME_LABEL, "h")
    affinity(sixth, wk.TOPOLOGY_ZONE_LABEL, "z")
    anti(sixth, wk.HOSTNAME_LABEL, "h")
    generic(count - len(pods), "fill")
    return pods


def live_cluster(claims) -> list:
    """One registered, initialized ``StateNode`` per claim of a solve, as
    the kwok provider launches it (``cloudprovider/kwok.py`` ``create``):
    the instance type and offering of ``cheapest_effective_offering`` over
    the claim's types, requirements and requests; the claim's labels plus
    that offering's zone and capacity type, the type's name, the nodepool
    and the claim's hostname; the type's capacity and allocatable; and the
    claim's pods bound to it."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.objects import Node, ObjectMeta
    from karpenter_tpu_torch.cloudprovider.types import (
        cheapest_effective_offering,
    )
    from karpenter_tpu_torch.state.statenode import StateNode

    nodes = []
    for claim in claims:
        best = cheapest_effective_offering(
            claim.instance_types, claim.requirements, claim.requests)
        if best is None:
            raise ValueError(f"no instance type can launch {claim}")
        it, offering = best
        name = claim.hostname
        labels = {
            **claim.template.labels,
            **claim.requirements.labels(),
            wk.NODEPOOL_LABEL: claim.template.nodepool_name,
            wk.INSTANCE_TYPE_LABEL: it.name,
            wk.TOPOLOGY_ZONE_LABEL: offering.zone,
            wk.CAPACITY_TYPE_LABEL: offering.capacity_type,
            wk.HOSTNAME_LABEL: name,
            wk.NODE_REGISTERED_LABEL: "true",
            wk.NODE_INITIALIZED_LABEL: "true",
        }
        sn = StateNode(provider_id=f"kwok://{name}")
        sn.node = Node(metadata=ObjectMeta(name=name, labels=labels),
                       provider_id=sn.provider_id,
                       capacity=dict(it.capacity),
                       allocatable=dict(it.allocatable()))
        for pod in claim.pods:
            pod.node_name = name
            sn.pods[pod.key()] = pod
        nodes.append(sn)
    return nodes


def live_round(claims, templates, instance_types, n_pods=5_000, seed=42):
    """(burst, topology, existing_nodes) of one provisioning round on the
    cluster ``live_cluster(claims)`` builds: ``diverse_pods(n_pods, seed)``
    pending, the topology assembled as the provisioner assembles it (the
    domain universe of every template over its pool's types, the burst
    registered), and every node an ``ExistingNode`` over that topology."""
    from karpenter_tpu_torch.controllers.provisioning.provisioner import (
        collect_domains,
    )
    from karpenter_tpu_torch.models.existing import ExistingNode
    from karpenter_tpu_torch.models.topology import Topology

    burst = diverse_pods(n_pods, seed)
    domains: dict = {}
    for t in templates:
        collect_domains(domains, t, instance_types[t.nodepool_name])
    topology = Topology(domains=domains, pods=burst)
    existing = [ExistingNode(sn, topology) for sn in live_cluster(claims)]
    return burst, topology, existing


FLEET_POD_CPU, FLEET_POD_MEM_GIB = 5.0, 10.0


def fleet_layout(n_nodes: int, n_groups: int | None = None) -> list:
    """The pods of the underutilized fleet, node by node: a list with one
    entry per node, each the ``(deployment, pod name)`` of its pods.

    The layout follows from two rules of the JAX package's environment:
    the provisioner packs a deployment's replicas three to a 16-cpu node
    in creation order (the claims open in that order), and a scale-down
    keeps the first-created replicas (``kube/workload.py``). So with
    ``n_groups`` None (``config4_consolidation_env``: ``n_nodes``
    deployments of 3 replicas, scaled to 1) node i keeps one pod of
    deployment i; with ``n_groups`` (``config4_xl_env``: each deployment
    ``3·per_group`` replicas on ``per_group = n_nodes // n_groups`` nodes,
    scaled to ``per_group``) the deployment's first nodes keep three pods
    each and its other nodes are empty."""
    if n_groups is None:
        return [[(f"d{i}", f"d{i}-0")] for i in range(n_nodes)]
    per_group = max(n_nodes // n_groups, 1)
    nodes = []
    for j in range(n_groups):
        for k in range(per_group):
            nodes.append([(f"d{j}", f"d{j}-{r}")
                          for r in range(3 * k, min(3 * k + 3, per_group))])
    return nodes


def underutilized_fleet(n_nodes: int, n_groups: int | None = None,
                        device=None):
    """``(store, cluster, provisioner, candidates)`` for the underutilized
    fleet of ``fleet_layout(n_nodes, n_groups)``: a port
    ``KubeStore`` holding the nodepool, one launched, registered and
    initialized NodeClaim and its Node per node (the instance type and
    offering ``KwokCloudProvider.create`` picks), and the bound pods; a
    ``Cluster`` fed the store's events; a ``Provisioner`` whose solver is
    ``TorchSolver(device)`` (None means CUDA); and the disruption
    candidates in ``disruption_cost`` order, stable (the disruption
    methods' order)."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.nodeclaim import (
        COND_INITIALIZED,
        COND_LAUNCHED,
        COND_REGISTERED,
        NodeClaim,
        NodeClaimSpec,
    )
    from karpenter_tpu_torch.api.nodepool import NodePool
    from karpenter_tpu_torch.api.objects import (
        NodeSelectorRequirement,
        ObjectMeta,
        Pod,
    )
    from karpenter_tpu_torch.cloudprovider.catalog import make_instance_type
    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_tpu_torch.controllers.disruption.helpers import get_candidates
    from karpenter_tpu_torch.controllers.provisioning.provisioner import (
        Provisioner,
    )
    from karpenter_tpu_torch.kube.store import KubeStore
    from karpenter_tpu_torch.models.solver import TorchSolver
    from karpenter_tpu_torch.state.cluster import Cluster
    from karpenter_tpu_torch.utils.clock import FakeClock

    solver = TorchSolver(device)
    clock = FakeClock()
    store = KubeStore(clock=clock)
    cloud = KwokCloudProvider(store, [make_instance_type("xl", 16, 64)])
    pool = NodePool(metadata=ObjectMeta(name="default"))
    pool.spec.disruption.consolidate_after = 0.0
    pool.spec.disruption.budgets[0].nodes = "100%"
    store.create("nodepools", pool)
    # the claims were sized for the three replicas each node held
    requests = {"cpu": 3 * FLEET_POD_CPU,
                "memory": 3 * FLEET_POD_MEM_GIB * GIB, "pods": 3.0}
    for i, pods in enumerate(fleet_layout(n_nodes, n_groups)):
        name = f"default-{i:05d}"
        claim = cloud.create(NodeClaim(
            metadata=ObjectMeta(name=name, namespace="",
                                labels={wk.NODEPOOL_LABEL: "default"}),
            spec=NodeClaimSpec(
                requirements=[NodeSelectorRequirement(
                    key=wk.NODEPOOL_LABEL, operator="In",
                    values=["default"])],
                resource_requests=dict(requests))))
        for cond in (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED):
            claim.set_condition(cond)
        store.create("nodeclaims", claim)
        # registration and initialization, as the lifecycle controller
        # leaves a node: startup taints gone, the two labels set
        node = store.get("nodes", name)
        node.taints = []
        node.metadata.labels[wk.NODE_REGISTERED_LABEL] = "true"
        node.metadata.labels[wk.NODE_INITIALIZED_LABEL] = "true"
        store.update("nodes", node)
        for deployment, pod_name in pods:
            store.create("pods", Pod(
                metadata=ObjectMeta(
                    name=pod_name, namespace="default",
                    owner_references=[{"kind": "Deployment",
                                       "name": deployment,
                                       "controller": True}]),
                requests={"cpu": FLEET_POD_CPU,
                          "memory": FLEET_POD_MEM_GIB * GIB},
                node_name=name, phase="Running"))
    cluster = Cluster(store, clock=clock)
    for event in store.drain_events():
        cluster.on_event(event)
    provisioner = Provisioner(store, cloud, solver=solver, clock=clock,
                              cluster=cluster)
    candidates = sorted(get_candidates(cluster, store, cloud, clock),
                        key=lambda c: c.disruption_cost)
    return store, cluster, provisioner, candidates


def consolidation_env(n_nodes: int, n_groups: int | None = None,
                      solver=None):
    """The port's ``Environment`` holding the underutilized fleet, built
    through the operator loop: the copy of ``perf/configs.py:107
    config4_consolidation_env`` (``n_groups`` None: ``n_nodes``
    deployments of 3 replicas of 5 cpu / 10 GiB) and ``:154
    config4_xl_env`` (``n_groups`` deployments of ``3·per_group``
    replicas, ``per_group = n_nodes // n_groups``). One ``xl`` type (16
    cpu, 64 GiB), one ``default`` pool (consolidate at once, a 100%
    budget), ``spot_to_spot_consolidation`` on. The deployments are
    provisioned and bound, then scaled to a third; the environment is
    returned with the disruption controller armed (``poll_period`` 0),
    before its first round. ``solver`` None means ``TorchSolver()`` (CUDA).
    """
    from karpenter_tpu_torch.api.nodepool import NodePool
    from karpenter_tpu_torch.api.objects import Deployment, ObjectMeta
    from karpenter_tpu_torch.cloudprovider.catalog import make_instance_type
    from karpenter_tpu_torch.operator import Environment
    from karpenter_tpu_torch.operator.options import Options

    env = Environment(
        instance_types=[make_instance_type("xl", 16, 64)],
        solver=solver,
        enable_disruption=True,
        options=Options.from_env(
            feature_gates={"spot_to_spot_consolidation": True}),
    )
    # disruption idles until the fleet stands: poll() is gated by cluster
    # sync, which needs at least one reconcile sweep first
    env.disruption.poll_period = float("inf")
    pool = NodePool(metadata=ObjectMeta(name="default"))
    pool.spec.disruption.consolidate_after = 0.0
    pool.spec.disruption.budgets[0].nodes = "100%"
    env.create("nodepools", pool)
    if n_groups is None:
        replicas, kept, count, rounds = 3, 1, n_nodes, 200
    else:
        per_group = max(n_nodes // n_groups, 1)
        replicas, kept, count, rounds = 3 * per_group, per_group, n_groups, 400
    deploys = [
        Deployment(metadata=ObjectMeta(name=f"d{i}"), replicas=replicas,
                   template=_pod(f"d{i}-tpl", FLEET_POD_CPU,
                                 FLEET_POD_MEM_GIB))
        for i in range(count)
    ]
    for d in deploys:
        env.store.create("deployments", d)
    env.run_until_idle(max_rounds=rounds)
    # scale every deployment to a third: the fleet drops to ~1/3 util
    for d in deploys:
        d.replicas = kept
        env.store.update("deployments", d)
    env.run_until_idle(max_rounds=rounds)
    env.disruption.poll_period = 0.0
    return env


def _pool(name="default"):
    from karpenter_tpu_torch.api.nodepool import NodePool
    from karpenter_tpu_torch.api.objects import ObjectMeta

    return NodePool(metadata=ObjectMeta(name=name))


def priority_mix(n_pods=5000, n_types=100, seed=7):
    """The ``priority-mix`` admission family (``perf/configs.py:319``): a
    seeded burst spread over three priority tiers (8000, 1000, 0) with the
    reference benchmark's size menus, plus a light arch-selector mix so
    the tiers don't collapse into one signature. Returns (pods, pools,
    catalog)."""
    import random

    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.cloudprovider.catalog import benchmark_catalog

    r = random.Random(seed)
    catalog = benchmark_catalog(n_types)
    pools = [_pool()]
    CPUS = (0.25, 0.5, 1.0, 2.0)
    MEMS = (0.5, 1.0, 2.0, 4.0)
    TIERS = (8000, 1000, 0)
    pods = []
    for i in range(n_pods):
        p = _pod(f"pr{i}", r.choice(CPUS), r.choice(MEMS))
        p.priority = r.choice(TIERS)
        if r.random() < 0.25:
            p.node_selector = {wk.ARCH_LABEL: r.choice(("amd64", "arm64"))}
        pods.append(p)
    return pods, pools, catalog


def gang_mix(n_pods=3000, n_types=100, seed=11, n_gangs=20):
    """The ``gang-mix`` admission family (``perf/configs.py:343``): loose
    pods plus annotation-keyed pod-groups of 4-16 members (half
    zone-co-located), the last one starved (min-member above the members
    present) so it must route whole. Returns (pods, pools, catalog)."""
    import random

    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_tpu_torch.cloudprovider.catalog import benchmark_catalog

    r = random.Random(seed)
    catalog = benchmark_catalog(n_types, zones=("zone-1", "zone-2", "zone-3"))
    pools = [_pool()]
    pods = []
    for i in range(n_pods - n_gangs * 8):
        p = _pod(f"l{i}", r.choice((0.25, 0.5, 1.0)), r.choice((1.0, 2.0)))
        p.priority = r.choice((0, 1000))
        pods.append(p)
    for g in range(n_gangs):
        size = r.choice((4, 8, 12, 16))
        annotations = {wk.POD_GROUP_ANNOTATION: f"gang-{g}"}
        if g % 2 == 0:
            annotations[wk.POD_GROUP_TOPOLOGY_ANNOTATION] = (
                wk.TOPOLOGY_ZONE_LABEL)
        if g == n_gangs - 1:
            annotations[wk.POD_GROUP_MIN_ANNOTATION] = str(size + 8)
        for i in range(size):
            p = Pod(
                metadata=ObjectMeta(name=f"g{g}-{i}",
                                    annotations=dict(annotations)),
                requests={"cpu": 2.0, "memory": 4.0 * GIB},
            )
            p.priority = 1000
            pods.append(p)
    return pods, pools, catalog


def preempt_env(n_nodes=8, solver=None):
    """The ``preempt-mix`` scenario (``perf/configs.py:380``): a fleet
    capped at ``16 * n_nodes`` cpu, filled by ``n_nodes`` deployments of
    three low-priority 5-cpu replicas, with ``high`` (10000) and ``low``
    (0) PriorityClasses. Returns the port's ``Environment`` with the low
    tier bound; the caller injects the high tier. ``solver`` None means
    ``TorchSolver()`` (CUDA)."""
    from karpenter_tpu_torch.api.objects import (
        Deployment,
        ObjectMeta,
        PriorityClass,
    )
    from karpenter_tpu_torch.cloudprovider.catalog import make_instance_type
    from karpenter_tpu_torch.operator import Environment

    env = Environment(instance_types=[make_instance_type("xl", 16, 64)],
                      solver=solver)
    pool = _pool()
    pool.spec.limits = {"cpu": str(16 * n_nodes)}
    env.create("nodepools", pool)
    env.create(
        "priorityclasses",
        PriorityClass(metadata=ObjectMeta(name="high"), value=10000),
        PriorityClass(metadata=ObjectMeta(name="low"), value=0),
    )
    for i in range(n_nodes):
        env.store.create("deployments", Deployment(
            metadata=ObjectMeta(name=f"low{i}"), replicas=3,
            template=_pod(f"low{i}-tpl", 5.0, 8.0,
                          priority_class_name="low")))
    env.run_until_idle(max_rounds=300)
    return env


# the spot storm's market (perf/configs.py:203): four zones whose SPOT
# offerings anti-correlate price and interruption risk — the cheap zones
# are the ones the storm reclaims
SPOT_PRICE_BY_ZONE = {"zone-1": 0.20, "zone-2": 0.24,
                      "zone-3": 0.38, "zone-4": 0.40}
SPOT_RISK_BY_ZONE = {"zone-1": 0.85, "zone-2": 0.55,
                     "zone-3": 0.04, "zone-4": 0.02}


def spot_catalog():
    from karpenter_tpu_torch.cloudprovider.catalog import make_instance_type

    return [make_instance_type(
        "xl", 16, 64,
        spot_price_by_zone=dict(SPOT_PRICE_BY_ZONE),
        spot_risk=dict(SPOT_RISK_BY_ZONE),
    )]


def spot_env(n_nodes=1000, solver=None):
    """The spot storm's fleet (``perf/configs.py:219``): ``n_nodes``
    deployments of three spot-pinned 5-cpu replicas, each filling one
    16-cpu spot node, so churn comes only from the storm and placement is
    pure price policy. Returns the port's ``Environment`` with disruption
    armed and idle. ``solver`` None means ``TorchSolver()`` (CUDA)."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.objects import Deployment, ObjectMeta
    from karpenter_tpu_torch.operator import Environment

    env = Environment(instance_types=spot_catalog(), solver=solver,
                      enable_disruption=True)
    env.disruption.poll_period = float("inf")
    pool = _pool()
    pool.spec.disruption.consolidate_after = 0.0
    pool.spec.disruption.budgets[0].nodes = "100%"
    env.create("nodepools", pool)
    for i in range(n_nodes):
        tpl = _pod(f"s{i}-tpl", 5.0, 10.0,
                   node_selector={wk.CAPACITY_TYPE_LABEL: "spot"})
        env.store.create("deployments", Deployment(
            metadata=ObjectMeta(name=f"s{i}"), replicas=3, template=tpl))
    env.run_until_idle(max_rounds=300)
    env.disruption.poll_period = 0.0
    return env


def fleet_cost(env) -> float:
    """The fleet's summed NOMINAL offering prices (``perf/run.py``'s
    ``_fleet_cost``: the end-state cost the spot legs compare)."""
    from karpenter_tpu_torch.cloudprovider.types import CatalogView

    view = CatalogView(env.store.list("nodepools"), env.disruption.cloud)
    total = 0.0
    for node in env.store.list("nodes"):
        o = view.offering(node.labels)
        if o is not None:
            total += o.price
    return total


def spot_storm(n_nodes=1000, lam=2.0, rounds=10, rate=0.25, step=30.0,
               seed=7, shift=1.25, solver=None, on_env=None) -> dict:
    """One leg of ``perf/run.py``'s ``run_spot`` through the port: build
    ``spot_env(n_nodes)`` with ``KARPENTER_SPOT_RISK_LAMBDA=lam``, arm
    ``ChaosCloud(random.Random(seed))`` and run ``rounds`` storm rounds
    (a notice storm at ``rate`` with a lead of two steps; a no-lead notice
    on an un-noticed node every 4th round; a ×``shift`` price shift on
    risk ≥ 0.5 every 2nd round; ``step`` seconds per round, reclaims at
    the deadlines), then four sweeps. ``on_env(env)`` is called once the
    fleet stands, before the storm. Returns the leg's counts and end
    state; ``run_spot``'s fleet-ledger reconciliation block (its ``ledger``
    keys) is left out."""
    import random

    from karpenter_tpu_torch.cloudprovider.chaos import ChaosCloud
    from karpenter_tpu_torch.operator import metrics as m
    from karpenter_tpu_torch.utils.envknobs import applied_env

    with applied_env({"KARPENTER_SPOT_RISK_LAMBDA": str(lam)},
                     ("KARPENTER_SPOT_RISK_LAMBDA",)):
        env = spot_env(n_nodes, solver=solver)
        if on_env is not None:
            on_env(env)
        chaos = ChaosCloud(random.Random(seed)).arm(env)
        pool = env.store.list("nodepools")[0]
        offerings = [o for it in env.cloud.get_instance_types(pool)
                     for o in it.offerings]
        created = env.registry.counter(m.NODECLAIMS_CREATED, "")
        creates0 = created.total()
        for r in range(rounds):
            # the two-minute warning: a lead of two rounds, so the
            # proactive path has a full round of slack
            chaos.notice_storm(rate, lead_s=2.0 * step, early=True)
            if r % 4 == 3:
                # a no-lead notice exercises the degraded rung; only
                # UN-noticed nodes qualify, so a with-lead node's early
                # flag is never overwritten
                free = [t for t in chaos._node_risks()
                        if not chaos.has_notice(t[0].provider_id)]
                if free:
                    node, _ = chaos.rng.choice(free)
                    chaos.inject_notice(
                        node.provider_id, env.clock.now() + 1.0,
                        early=False)
            if r % 2 == 1:
                chaos.shift_prices(offerings, factor=shift, min_risk=0.5)
            env.run_until_idle(max_rounds=500)
            env.clock.step(step)
            env.run_until_idle(max_rounds=500)
            chaos.reclaim_expired()
            env.run_until_idle(max_rounds=500)
        # storm over: sweep the remaining deadlines and converge
        for _ in range(4):
            env.clock.step(step)
            env.run_until_idle(max_rounds=500)
            chaos.reclaim_expired()
            env.run_until_idle(max_rounds=500)
        reg = env.registry
        return {
            "lambda": lam,
            "end_nodes": len(env.store.list("nodes")),
            "pods_bound": len(
                [p for p in env.store.list("pods") if p.node_name]),
            "end_cost": round(fleet_cost(env), 6),
            "creates": int(created.total() - creates0),
            "notices": chaos.stats["notices"],
            "reclaims": chaos.stats["reclaims"],
            "price_shifts": chaos.stats["price_shifts"],
            "pods_lost": chaos.stats["pods_lost"],
            "pods_lost_with_lead": chaos.stats["pods_lost_with_lead"],
            "proactive_drains": int(reg.counter(
                m.INTERRUPTION_PROACTIVE_DRAINS, "").total()),
            "deadline_degradations": int(reg.counter(
                m.INTERRUPTION_DEADLINE_DEGRADATIONS, "").total()),
            "env": env,
        }


def spot_gates(aware: dict, blind: dict, n_nodes: int) -> dict:
    """``perf/run.py``'s three spot gates over a risk-aware and a
    risk-blind leg: the aware fleet ends strictly cheaper, its creates
    stay within ``2 × notices + 2% of the fleet + 8``, and no pod is lost
    to a reclaim whose notice came with lead, on either leg."""
    churn_bound = int(2 * aware["notices"] + 0.02 * n_nodes + 8)
    return {
        "cost_beats_blind": bool(
            aware["end_cost"] < blind["end_cost"] - 1e-9),
        "churn_bound": churn_bound,
        "churn_bound_ok": bool(aware["creates"] <= churn_bound),
        "zero_late_drain_ok": bool(
            aware["pods_lost_with_lead"] == 0
            and blind["pods_lost_with_lead"] == 0),
    }


def multitenant_workload(seed: int, r: int, pods_per_round: int = 40) -> list:
    """One tenant's round-``r`` pods: ``pods_per_round`` pods of seeded
    cpu (0.25–2) and memory (1–4 GiB) requests."""
    import random

    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod

    rng = random.Random(seed * 1009 + r)
    return [
        Pod(metadata=ObjectMeta(name=f"t{seed}-r{r}-p{i}"),
            requests={"cpu": float(rng.choice([0.25, 0.5, 1.0, 2.0])),
                      "memory": float(rng.choice([1, 2, 4])) * GIB})
        for i in range(pods_per_round)
    ]


@contextmanager
def solver_server(device=None, env=None, log=None):
    """A solver service (``python -m karpenter_tpu_torch.service.
    solver_service``) started as a process of its own on ``device`` (the
    card when None), on loopback with a metrics server, and stopped on
    exit. ``env`` overrides its environment (``KARPENTER_COALESCE_WINDOW_MS``
    defaults to 4); ``log`` receives its output. Yields ``(target,
    metrics_port)`` once a Register round trip answers. Needs ``grpc``."""
    import os
    import socket
    import subprocess
    import sys
    import time

    import grpc

    from karpenter_tpu_torch.service.solver_service import (
        _GRPC_OPTS,
        _METHOD_REGISTER,
        _pack,
    )
    from karpenter_tpu_torch.utils.envknobs import inherited_env

    def _free_port() -> int:
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        return port

    grpc_port, metrics_port = _free_port(), _free_port()
    child_env = inherited_env()
    child_env.setdefault("KARPENTER_COALESCE_WINDOW_MS", "4")
    child_env.update(env or {})
    argv = [sys.executable, "-m", "karpenter_tpu_torch.service.solver_service",
            "--host", "127.0.0.1", "--port", str(grpc_port),
            "--metrics-port", str(metrics_port)]
    if device is not None:
        argv += ["--device", str(device)]
    out = open(log, "w") if log else subprocess.DEVNULL
    proc = subprocess.Popen(
        argv, env=child_env, stdout=out, stderr=subprocess.STDOUT,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    target = f"127.0.0.1:{grpc_port}"
    chan = grpc.insecure_channel(target, options=_GRPC_OPTS)
    try:
        # readiness: a Register round trip proves the serving stack is up
        ping = chan.unary_unary(_METHOD_REGISTER, request_serializer=None,
                                response_deserializer=None)
        deadline = time.monotonic() + 120.0
        while True:
            try:
                ping(_pack({}, {"tenant": "readiness-probe"}),
                     timeout=10.0, wait_for_ready=True)
                break
            except grpc.RpcError:
                if time.monotonic() > deadline or proc.poll() is not None:
                    raise RuntimeError(
                        f"solver service failed to start (rc {proc.poll()})")
                time.sleep(0.5)
        yield target, metrics_port
    finally:
        chan.close()
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if log:
            out.close()


def run_multitenant(n_tenants: int = 8, rounds: int = 3,
                    pods_per_round: int = 40, think_ms: float = 200.0,
                    server=None, server_device=None, server_env=None,
                    oracle_device="cpu") -> dict:
    """The multi-tenant fleet row: ``n_tenants`` concurrent synthetic
    clusters sustain round-robin reconcile loops through ONE solver
    service — session mode, streaming deltas, coalesced dispatch — and
    the row reports per-tenant p50/p99 (the server's ``/slo``), the p99
    ratio against a single tenant on the same warm server, the coalesce
    rate, the session-cache hit rate, the delta accounting (steady state
    ships deltas only: full uploads == tenants, zero forced resyncs), the
    client's remote fallbacks, and a seeded isolation verdict — every
    tenant's per-round claim compositions diffed against its solo
    in-process oracle (``TorchSolver(device=oracle_device)``). The
    clients are CPU processes' (``RemoteSolver``'s default device).
    ``server`` is a running service's ``(target, metrics_port)``; without
    one, ``solver_server`` starts one on ``server_device`` with
    ``server_env`` for the row. Needs ``grpc``."""
    if server is None:
        with solver_server(server_device, server_env) as srv:
            return run_multitenant(
                n_tenants, rounds, pods_per_round, think_ms, server=srv,
                oracle_device=oracle_device)
    import json
    import random
    import threading
    import time
    import urllib.request

    from karpenter_tpu_torch.api.nodepool import NodePool
    from karpenter_tpu_torch.api.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.catalog import benchmark_catalog
    from karpenter_tpu_torch.models import ClaimTemplate, TorchSolver
    from karpenter_tpu_torch.obs import decisions
    from karpenter_tpu_torch.operator import metrics as m
    from karpenter_tpu_torch.operator.metrics import Registry
    from karpenter_tpu_torch.service import RemoteSolver

    config = f"multitenant-{n_tenants}x{rounds}x{pods_per_round}"
    target, metrics_port = server

    def _scrape(path: str) -> str:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{metrics_port}{path}", timeout=10
        ) as r:
            return r.read().decode()

    def _prom(text: str, name: str) -> list:
        """[(labels dict, value)] for one exposition family."""
        out = []
        for line in text.splitlines():
            if not line.startswith(name):
                continue
            rest = line[len(name):]
            labels = {}
            if rest.startswith("{"):
                inner, rest = rest[1:].split("}", 1)
                for kv in inner.split(","):
                    if kv:
                        k, v = kv.split("=", 1)
                        labels[k] = v.strip('"')
            elif not rest.startswith(" "):
                continue  # a longer family name sharing the prefix
            out.append((labels, float(rest.strip())))
        return out

    reg = Registry()  # client-side families (fallbacks, retries, bytes)
    pool = NodePool(metadata=ObjectMeta(name="default"))
    its = {pool.name: benchmark_catalog(40)}
    templates = [ClaimTemplate(pool)]
    # reconcile cadence: real clusters think between rounds
    think_s = think_ms / 1000.0

    def reconcile_loop(tenant: str, seed: int, sizes: dict,
                       stagger: float = 0.0):
        solver = RemoteSolver(target, registry=reg, tenant=tenant)
        per_round = []
        # each cluster's reconcile cadence has its own phase and jitter
        rng = random.Random(seed ^ 0x5EED)
        if stagger:
            time.sleep(stagger * rng.random())
        for r in range(rounds):
            res = solver.solve(multitenant_workload(seed, r, pods_per_round),
                               templates, its)
            per_round.append(sorted(len(c.pods) for c in res.new_claims))
            if think_s and r + 1 < rounds:
                time.sleep(think_s * (0.75 + 0.5 * rng.random()))
        sizes[tenant] = (per_round, solver.session_stats)

    def run_fleet(prefix: str, sizes: dict, errors: dict | None = None):
        def guarded(tenant, seed):
            try:
                reconcile_loop(tenant, seed, sizes, think_s)
            except Exception as e:  # reported in the row
                if errors is None:
                    raise
                errors[tenant] = f"{type(e).__name__}: {e}"

        threads = [
            threading.Thread(target=guarded, args=(f"{prefix}-{i}", i))
            for i in range(n_tenants)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return (time.perf_counter() - t0) * 1000.0

    fallbacks0 = reg.counter(m.SOLVER_REMOTE_FALLBACKS).total()
    # warm the shape families — solo AND concurrent — so the measured
    # phase is the steady state every tenant rides
    reconcile_loop("warm", 999, {})
    run_fleet("warm", {})
    # single-tenant baseline on the same warm server, once per tenant so
    # its p99 pools as many samples as the worst-tenant max
    single: dict = {}
    for _ in range(n_tenants):
        reconcile_loop("single", 998, single)

    pre = _scrape("/metrics")
    reqs0 = sum(v for _, v in _prom(
        pre, "karpenter_solver_coalesce_batch_size_sum"))
    coalesced0 = sum(v for _, v in _prom(
        pre, "karpenter_solver_coalesced_requests_total"))
    dec0 = decisions.counts()
    sizes: dict = {}
    fleet_errors: dict = {}
    total_ms = run_fleet("tenant", sizes, errors=fleet_errors)
    fleet_rungs = decisions.rung_delta(dec0, decisions.counts())
    missing = [f"tenant-{i}" for i in range(n_tenants)
               if f"tenant-{i}" not in sizes]
    if missing:
        return {"config": config, "degraded": True,
                "error": {t: fleet_errors.get(t, "thread died without "
                          "reporting") for t in missing}}
    fallbacks = int(reg.counter(m.SOLVER_REMOTE_FALLBACKS).total()
                    - fallbacks0)

    # seeded isolation: every tenant's per-round claim compositions must
    # equal its solo in-process oracle's
    isolation_ok = True
    for i in range(n_tenants):
        oracle = TorchSolver(device=oracle_device)
        for r in range(rounds):
            ref = oracle.solve(multitenant_workload(i, r, pods_per_round),
                               templates, its)
            got = sizes[f"tenant-{i}"][0][r]
            if got != sorted(len(c.pods) for c in ref.new_claims):
                isolation_ok = False

    slo = json.loads(_scrape("/slo"))
    tenants_view = slo["slo"]["solver_service"].get("tenants", {})
    per_tenant = {
        t: {
            "p50": tenants_view.get(t, {}).get("p50_ms", 0.0),
            "p95": tenants_view.get(t, {}).get("p95_ms", 0.0),
            "p99": tenants_view.get(t, {}).get("p99_ms", 0.0),
        }
        for t in (f"tenant-{i}" for i in range(n_tenants))
    }
    worst_p99 = max(q["p99"] for q in per_tenant.values())
    single_p99 = tenants_view.get("single", {}).get("p99_ms", 0.0)
    deltas = {"full_uploads": 0, "delta_rounds": 0, "resyncs": 0,
              "retries": 0, "bytes_full": 0, "bytes_delta": 0}
    for _, stats in sizes.values():
        for k in deltas:
            deltas[k] += stats.get(k, 0)
    post = _scrape("/metrics")
    total_reqs = sum(v for _, v in _prom(
        post, "karpenter_solver_coalesce_batch_size_sum")) - reqs0
    coalesced = sum(v for _, v in _prom(
        post, "karpenter_solver_coalesced_requests_total")) - coalesced0
    measured = {f"tenant-{i}" for i in range(n_tenants)}
    hits = sum(
        v for lb, v in _prom(post, "karpenter_solver_session_cache_hits_total")
        if lb.get("tenant") in measured and lb.get("kind") == "delta")
    stores = sum(
        v for lb, v in _prom(post,
                             "karpenter_solver_session_cache_stores_total")
        if lb.get("tenant") in measured)
    evictions = sum(
        v for lb, v in _prom(
            post, "karpenter_solver_session_cache_evictions_total")
        if lb.get("tenant") in measured)
    bleed = sum(
        v for lb, v in _prom(post, "karpenter_solver_bleed_checks_total")
        if lb.get("outcome") == "bleed")
    if bleed:
        isolation_ok = False
    # the billing plane (/usage): the per-tenant billed total must equal
    # the server's own devplane dispatch-seconds ledger
    usage = json.loads(_scrape("/usage"))
    billing_gap = abs(usage["total_device_seconds"]
                      - usage["devplane_dispatch_seconds"])
    return {
        "config": config,
        "tenants": n_tenants,
        "rounds": rounds,
        "total_ms": total_ms,
        "single_p99_ms": single_p99,
        "worst_p99_ms": worst_p99,
        "p99_ratio": worst_p99 / max(single_p99, 1e-9),
        "per_tenant": per_tenant,
        "coalesce": {
            "requests": int(total_reqs),
            "coalesced": int(coalesced),
            "rate": coalesced / total_reqs if total_reqs else 0.0,
        },
        "session_cache": {
            "hits": int(hits),
            "stores": int(stores),
            "hit_rate": hits / (hits + stores) if hits + stores else 0.0,
            "evictions": int(evictions),
        },
        "deltas": deltas,
        "deltas_only_steady_state": (
            deltas["full_uploads"] == n_tenants and deltas["resyncs"] == 0),
        "isolation_ok": isolation_ok,
        "billing_sums_ok": bool(billing_gap <= 1e-3),
        "rungs": fleet_rungs,
        # >0 means some solves never crossed the service
        "client_fallbacks": fallbacks,
        "degraded": fallbacks > 0 or single_p99 <= 0,
    }
