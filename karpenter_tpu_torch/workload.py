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
"""

from __future__ import annotations

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
