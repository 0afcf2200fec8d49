"""The port's interruption path against the JAX package's.

Each case is built twice, each time with one package's own objects and
driven through that package's ``Environment`` (the JAX package with
``TPUSolver`` on the CPU, the port with ``TorchSolver(device="cpu")``);
the harness is ``tests/test_torch_operator.py``'s. Tolerance: exact.

- **ChaosCloud**: one seed gives the same notices (by node), the same
  price shifts, the same ICEs and the same reclaims with the same losses;
  ``FakeCloudProvider`` launches, refuses and forgets as the JAX
  package's does.
- **The drain** (the shapes of ``tests/test_spot_resilience.py``): a
  notice with lead replaces the node before its drain wave evicts a pod;
  a short lead degrades only its own node; a PDB-blocked drain waits for
  the deadline and loses its pods to the reclaim; a notice for an unknown
  node is counted and ignored. In each, the same commands (method, rung
  and reason, candidates by creation order, replacement types) and the
  same end state as the JAX package.
- **The absorb probe**: its answers over a storm round equal the JAX
  package's; a host-side error inside it falls back to the confirming
  simulation and is counted, a kernel fault propagates.
- **A small storm** (24 nodes, 6 rounds, seed 7, as
  ``tests/test_spot_resilience.py``'s mini storm) through both packages'
  loops, risk-aware (λ 2.0) and risk-blind (λ 0): the same command log,
  counts and end state on each leg, and ``perf/run.py``'s three gates.
"""

from __future__ import annotations

import functools
import random

import pytest

from tests.test_torch_operator import (
    JAX,
    PORT,
    CommandLog,
    Kit,
    end_state,
    mod,
)

GIB = 2**30


def _chaos(pkg, seed, **kw):
    return mod(pkg, "cloudprovider.chaos").ChaosCloud(random.Random(seed),
                                                      **kw)


def build_env(pkg, catalog=None):
    """``tests/test_spot_resilience.py``'s ``build_env``."""
    k = Kit(pkg)
    env = k.Environment(
        instance_types=catalog or [k.make_instance_type("xl", 16, 64)],
        solver=k.solver(), enable_disruption=True)
    pool = k.nodepool()
    pool.spec.disruption.consolidate_after = 0.0
    pool.spec.disruption.budgets[0].nodes = "100%"
    env.create("nodepools", pool)
    return env


def deploy_fleet(env, pkg, n=2, replicas=3):
    k = Kit(pkg)
    for i in range(n):
        tpl = k.Pod(metadata=k.ObjectMeta(name=f"d{i}",
                                          labels={"app": f"d{i}"}),
                    requests={"cpu": 5.0, "memory": 10 * GIB})
        env.store.create("deployments", k.Deployment(
            metadata=k.ObjectMeta(name=f"d{i}"), replicas=replicas,
            template=tpl))
    env.run_until_idle(max_rounds=300)


def spot_fleet(pkg, n_nodes):
    if pkg == PORT:
        return mod(PORT, "workload").spot_env(n_nodes,
                                              solver=Kit(PORT).solver())
    from perf import configs

    return configs.spot_env(n_nodes)


def _metrics(env, pkg):
    m = mod(pkg, "operator.metrics")
    reg = env.registry
    return dict(
        notices=reg.counter(m.INTERRUPTION_NOTICES).value(outcome="marked"),
        unknown=reg.counter(m.INTERRUPTION_NOTICES).value(
            outcome="unknown-node"),
        proactive=reg.counter(m.INTERRUPTION_PROACTIVE_DRAINS).total(),
        degraded=reg.counter(m.INTERRUPTION_DEADLINE_DEGRADATIONS).total())


# ---------------------------------------------------------------------------
# ChaosCloud
# ---------------------------------------------------------------------------

def _chaos_run(pkg, seed):
    env = spot_fleet(pkg, 12)
    nodes = env.store.list("nodes")
    index = {n.provider_id: i for i, n in enumerate(nodes)}
    chaos = _chaos(pkg, seed, ice_rate=0.5, force_first_ice=True).arm(env)
    pool = env.store.list("nodepools")[0]
    offerings = [o for it in env.cloud.get_instance_types(pool)
                 for o in it.offerings]
    issued = []
    for r in range(4):
        issued.append(chaos.notice_storm(0.6, lead_s=60.0))
        chaos.shift_prices(offerings, factor=1.25, min_risk=0.5)
        chaos.flap_random_offering(offerings)
    notices = [(index[n.provider_id], n.deadline)
               for n in chaos.take_notices()]
    # creates through the armed provider: seeded ICEs
    ices = []
    claim = env.store.list("nodeclaims")[0]
    for _ in range(6):
        try:
            env.cloud.create(claim)
            ices.append(False)
        except mod(pkg, "cloudprovider.types").InsufficientCapacityError:
            ices.append(True)
    env.clock.step(120.0)
    reclaimed = chaos.reclaim_expired()
    return dict(issued=issued, notices=notices, ices=ices,
                reclaimed=reclaimed, stats=dict(chaos.stats),
                prices=sorted(round(o.price, 6) for o in offerings),
                available=[o.available for o in offerings],
                nodes=len(env.store.list("nodes")))


@pytest.mark.parametrize("seed", [7, 11])
def test_chaos_cloud_matches_jax(seed):
    got, want = _chaos_run(PORT, seed), _chaos_run(JAX, seed)
    assert got == want
    assert got["notices"] and got["stats"]["reclaims"] > 0
    assert got["stats"]["pods_lost"] == 3 * got["stats"]["reclaims"]
    assert True in got["ices"]


def _fake_run(pkg):
    """``FakeCloudProvider`` over the spot catalog: launches by the
    cheapest effective offering (λ 2.0 steers them off the risky zones),
    an injected create error, the create budget, and the delete/get
    errors."""
    wk = mod(pkg, "api.labels")
    ob = mod(pkg, "api.objects")
    nc = mod(pkg, "api.nodeclaim")
    types = mod(pkg, "cloudprovider.types")
    catalog = (mod(PORT, "workload").spot_catalog() if pkg == PORT else
               __import__("perf.configs", fromlist=["x"]).spot_catalog())
    fake = mod(pkg, "cloudprovider.fake").FakeCloudProvider(catalog)
    out = []

    def claim(i, ct):
        return nc.NodeClaim(
            metadata=ob.ObjectMeta(name=f"c{i}"),
            spec=nc.NodeClaimSpec(
                requirements=[ob.NodeSelectorRequirement(
                    wk.CAPACITY_TYPE_LABEL, "In", [ct])],
                resource_requests={"cpu": 5.0}))

    for i, ct in enumerate(("spot", "on-demand", "spot")):
        got = fake.create(claim(i, ct))
        out.append(tuple(got.metadata.labels[k] for k in (
            wk.INSTANCE_TYPE_LABEL, wk.TOPOLOGY_ZONE_LABEL,
            wk.CAPACITY_TYPE_LABEL)))
    for i, arm in enumerate(("next_create_err", "allowed_create_calls")):
        if arm == "next_create_err":
            fake.next_create_err = types.InsufficientCapacityError("injected")
        else:
            fake.allowed_create_calls = len(fake.create_calls)
        try:
            fake.create(claim(9 + i, "spot"))
        except types.InsufficientCapacityError as e:
            out.append(str(e))
    live = fake.list()
    fake.delete(live[0])
    for fn in (fake.delete, lambda c: fake.get(c.status.provider_id)):
        try:
            fn(live[0])
        except types.NodeClaimNotFoundError:
            out.append("not-found")
    out.append(len(fake.list()))
    return out


def test_fake_cloud_provider_matches_jax(monkeypatch):
    monkeypatch.setenv("KARPENTER_SPOT_RISK_LAMBDA", "2.0")
    got, want = _fake_run(PORT), _fake_run(JAX)
    assert got == want
    assert got[0][2] == "spot" and got[1][2] == "on-demand"
    assert got[-3:] == ["not-found", "not-found", 2]


# ---------------------------------------------------------------------------
# the drain, shape by shape
# ---------------------------------------------------------------------------

def _proactive(pkg):
    env = build_env(pkg)
    deploy_fleet(env, pkg)
    log = CommandLog(env)
    victim = env.store.list("nodes")[0]
    claims0 = {c.name for c in env.store.list("nodeclaims")}
    chaos = _chaos(pkg, 3).arm(env)
    chaos.inject_notice(victim.provider_id, env.clock.now() + 300.0)
    seen = {}
    inner_wave = env.store.evict_wave

    def spying_wave(pods):
        if ([p for p in pods if p.node_name == victim.metadata.name]
                and "at_first_evict" not in seen):
            fresh = [c for c in env.store.list("nodeclaims")
                     if c.name not in claims0]
            seen["at_first_evict"] = (
                len(fresh) > 0 and all(c.initialized for c in fresh))
        return inner_wave(pods)

    env.store.evict_wave = spying_wave
    env.run_until_idle(max_rounds=400)
    gone = victim.metadata.name not in [
        n.metadata.name for n in env.store.list("nodes")]
    env.clock.step(400.0)
    env.run_until_idle(max_rounds=200)
    chaos.reclaim_expired()
    return env, log, dict(gone=gone, ready_first=seen.get("at_first_evict"),
                          lost=chaos.stats["pods_lost"])


def _short_lead(pkg):
    env = build_env(pkg)
    deploy_fleet(env, pkg, n=3)
    log = CommandLog(env)
    nodes = env.store.list("nodes")
    chaos = _chaos(pkg, 23).arm(env)
    chaos.inject_notice(nodes[0].provider_id, env.clock.now() + 2.0,
                        early=False)
    chaos.inject_notice(nodes[1].provider_id, env.clock.now() + 600.0)
    env.run_until_idle(max_rounds=400)
    live = [n.metadata.name for n in env.store.list("nodes")]
    return env, log, dict(gone=[n.metadata.name not in live
                                for n in nodes[:2]])


def _pdb_blocked(pkg):
    k = Kit(pkg)
    env = build_env(pkg)
    deploy_fleet(env, pkg, n=1, replicas=3)
    env.create("pdbs", k.PodDisruptionBudget(
        metadata=k.ObjectMeta(name="block"),
        selector=k.LabelSelector(match_labels={"app": "d0"}),
        min_available="100%"))
    env.run_until_idle(max_rounds=100)
    log = CommandLog(env)
    victim = env.store.list("nodes")[0]
    chaos = _chaos(pkg, 11).arm(env)
    chaos.inject_notice(victim.provider_id, env.clock.now() + 120.0,
                        early=True)
    env.run_until_idle(max_rounds=400)
    held = victim.metadata.name in [
        n.metadata.name for n in env.store.list("nodes")]
    env.clock.step(150.0)
    env.run_until_idle(max_rounds=200)
    chaos.reclaim_expired()
    for _ in range(4):
        env.clock.step(30.0)
        env.run_until_idle(max_rounds=300)
    return env, log, dict(held=held, lost=chaos.stats["pods_lost"],
                          lost_with_lead=chaos.stats["pods_lost_with_lead"])


def _unknown_node(pkg):
    env = build_env(pkg)
    deploy_fleet(env, pkg, n=1)
    log = CommandLog(env)
    chaos = _chaos(pkg, 19).arm(env)
    chaos.inject_notice("kwok://no-such-node", env.clock.now() + 60.0)
    env.run_until_idle(max_rounds=100)
    return env, log, {}


SHAPES = {"proactive": _proactive, "short-lead": _short_lead,
          "pdb-blocked": _pdb_blocked, "unknown-node": _unknown_node}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_interruption_shapes_match_jax(shape):
    want_env, want_log, want = SHAPES[shape](JAX)
    got_env, got_log, got = SHAPES[shape](PORT)
    assert got_log.commands == want_log.commands
    assert end_state(got_env) == end_state(want_env)
    assert got == want
    metrics = _metrics(got_env, PORT)
    assert metrics == _metrics(want_env, JAX)
    methods = [c[0] for c in got_log.commands]
    if shape == "proactive":
        assert got == dict(gone=True, ready_first=True, lost=0)
        assert got_log.commands[0][:2] == ("InterruptionDrain",
                                           "proactive/ok")
        assert metrics["proactive"] == 1
    elif shape == "short-lead":
        # exactly one node degraded; the other was proactively replaced
        assert got["gone"] == [True, True]
        assert metrics["degraded"] == 1 and metrics["proactive"] == 1
        assert [c[1] for c in got_log.commands[:2]] == [
            "degraded/deadline-degraded", "proactive/ok"]
    elif shape == "pdb-blocked":
        assert got["held"] and got["lost"] == got["lost_with_lead"] == 3
        assert methods[0] == "InterruptionDrain"
        nodes, unbound, _ = end_state(got_env)
        assert not unbound and sum(len(n[4]) for n in nodes) == 3
    else:
        assert metrics["unknown"] == 1 and not got_log.commands


# ---------------------------------------------------------------------------
# the absorb probe
# ---------------------------------------------------------------------------

def _absorb_answers(pkg):
    """A fleet with consolidation candidates (so the round's prewarm
    builds a bundle) and two notices with lead: every absorb-probe answer
    in order. The fleet is packed, so the survivors absorb nothing."""
    env = build_env(pkg)
    deploy_fleet(env, pkg, n=3, replicas=2)
    answers = _spy_absorb(env)
    log = CommandLog(env)
    chaos = _chaos(pkg, 13).arm(env)
    nodes = env.store.list("nodes")
    chaos.inject_notice(nodes[0].provider_id, env.clock.now() + 300.0)
    env.run_until_idle(max_rounds=400)
    chaos.inject_notice(env.store.list("nodes")[-1].provider_id,
                        env.clock.now() + 300.0)
    env.run_until_idle(max_rounds=400)
    return env, log, answers


def _absorb_spare_room(pkg):
    """Two nodes with room to spare (the fleet scaled down from three
    pods a node, voluntary disruption closed by a zero budget): a notice
    on the emptier node is absorbed by the other, the probe answers True
    and the delete-only drain ships without the host simulation."""
    env = build_env(pkg)
    deploy_fleet(env, pkg, n=3, replicas=2)
    pool = env.store.list("nodepools")[0]
    pool.spec.disruption.budgets[0].nodes = "0"
    env.store.update("nodepools", pool)
    for name, replicas in (("d0", 0), ("d1", 1)):
        d = env.store.get("deployments", name)
        d.replicas = replicas
        env.store.update("deployments", d)
    env.run_until_idle(max_rounds=300)
    answers = _spy_absorb(env)
    log = CommandLog(env)
    chaos = _chaos(pkg, 13).arm(env)
    bound = {n.metadata.name: 0 for n in env.store.list("nodes")}
    for p in env.store.list("pods"):
        if p.node_name in bound:
            bound[p.node_name] += 1
    emptiest = min(env.store.list("nodes"),
                   key=lambda n: (bound[n.metadata.name], n.metadata.name))
    chaos.inject_notice(emptiest.provider_id, env.clock.now() + 300.0)
    env.run_until_idle(max_rounds=400)
    return env, log, answers


def _spy_absorb(env):
    drain = next(mt for mt in env.disruption.methods
                 if type(mt).__name__ == "InterruptionDrain")
    answers = []
    real = drain._absorb_probe

    def spy(cands):
        out = real(cands)
        answers.append(out)
        return out

    drain._absorb_probe = spy
    return answers


@pytest.mark.parametrize("fleet", ["packed", "spare-room"])
def test_absorb_probe_matches_jax(fleet):
    run = _absorb_answers if fleet == "packed" else _absorb_spare_room
    got_env, got_log, got = run(PORT)
    want_env, want_log, want = run(JAX)
    assert got == want
    assert any(a is not None for a in got), "the probe never dispatched"
    assert got_log.commands == want_log.commands
    assert end_state(got_env) == end_state(want_env)
    if fleet == "spare-room":
        # the True answer is the one that decides: a delete-only drain
        # with no replacement, and every pod still bound
        assert got == [True]
        assert got_log.commands == [
            ("InterruptionDrain", "proactive/delete-only", "delete", (0,),
             ())]
        _, unbound, _ = end_state(got_env)
        assert not unbound
    else:
        assert True not in got


@pytest.mark.parametrize("fault", ["host-error", "kernel-fault"])
def test_absorb_probe_fault_rule(fault, monkeypatch):
    """A host-side error inside the absorb probe falls back to the
    confirming simulation and is counted; a kernel fault propagates."""
    from karpenter_tpu_torch.ops import consolidate as cons
    from karpenter_tpu_torch.ops.cuda_kernels import KernelError

    exc = NotImplementedError("x") if fault == "host-error" else (
        KernelError("launch"))

    def dispatch(self, *a, **kw):
        raise exc

    env = build_env(PORT)
    deploy_fleet(env, PORT, n=3, replicas=2)
    monkeypatch.setattr(cons.DisruptionSnapshot, "dispatch", dispatch)
    log = CommandLog(env)
    chaos = _chaos(PORT, 13).arm(env)
    victim = env.store.list("nodes")[0]
    chaos.inject_notice(victim.provider_id, env.clock.now() + 300.0)
    m = mod(PORT, "operator.metrics")
    if fault == "kernel-fault":
        with pytest.raises(KernelError):
            env.run_until_idle(max_rounds=400)
        return
    env.run_until_idle(max_rounds=400)
    failures = env.registry.counter(m.DISRUPTION_PROBE_FAILURES)
    assert failures.value(method="interruption") >= 1
    assert victim.metadata.name not in [
        n.metadata.name for n in env.store.list("nodes")]
    # the confirming simulation decided: a replacement launched first
    assert log.commands[0][:3] == ("InterruptionDrain", "proactive/ok",
                                   "replace")
    nodes, unbound, _ = end_state(env)
    assert not unbound


# ---------------------------------------------------------------------------
# a small storm through both loops
# ---------------------------------------------------------------------------

STORM = dict(n_nodes=24, rounds=6, rate=0.25, step=30.0, seed=7, shift=1.25)


def _jax_leg(lam, attach):
    """``perf/run.py``'s ``run_spot`` leg, through the JAX package, with
    ``attach(env)`` called before the storm (the ledger left out)."""
    import os

    from karpenter_tpu.operator import metrics as m
    from perf import configs

    s = STORM
    prior = os.environ.get("KARPENTER_SPOT_RISK_LAMBDA")
    os.environ["KARPENTER_SPOT_RISK_LAMBDA"] = str(lam)
    try:
        env = configs.spot_env(s["n_nodes"])
        attach(env)
        chaos = _chaos(JAX, s["seed"]).arm(env)
        pool = env.store.list("nodepools")[0]
        offerings = [o for it in env.cloud.get_instance_types(pool)
                     for o in it.offerings]
        created = env.registry.counter(m.NODECLAIMS_CREATED, "")
        creates0 = created.total()
        for r in range(s["rounds"]):
            chaos.notice_storm(s["rate"], lead_s=2.0 * s["step"], early=True)
            if r % 4 == 3:
                free = [t for t in chaos._node_risks()
                        if not chaos.has_notice(t[0].provider_id)]
                if free:
                    node, _ = chaos.rng.choice(free)
                    chaos.inject_notice(node.provider_id,
                                        env.clock.now() + 1.0, early=False)
            if r % 2 == 1:
                chaos.shift_prices(offerings, factor=s["shift"],
                                   min_risk=0.5)
            env.run_until_idle(max_rounds=500)
            env.clock.step(s["step"])
            env.run_until_idle(max_rounds=500)
            chaos.reclaim_expired()
            env.run_until_idle(max_rounds=500)
        for _ in range(4):
            env.clock.step(s["step"])
            env.run_until_idle(max_rounds=500)
            chaos.reclaim_expired()
            env.run_until_idle(max_rounds=500)
        reg = env.registry
        return {
            "lambda": lam,
            "end_nodes": len(env.store.list("nodes")),
            "pods_bound": len(
                [p for p in env.store.list("pods") if p.node_name]),
            "end_cost": round(configs_fleet_cost(env), 6),
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
    finally:
        if prior is None:
            os.environ.pop("KARPENTER_SPOT_RISK_LAMBDA", None)
        else:
            os.environ["KARPENTER_SPOT_RISK_LAMBDA"] = prior


def configs_fleet_cost(env) -> float:
    from perf.run import _fleet_cost

    return _fleet_cost(env)


@functools.lru_cache(maxsize=None)
def storm_leg(pkg, lam):
    logs = []

    def attach(env):
        logs.append(CommandLog(env))

    if pkg == PORT:
        s = dict(STORM)
        leg = mod(PORT, "workload").spot_storm(
            s.pop("n_nodes"), lam=lam, solver=Kit(PORT).solver(),
            on_env=attach, **s)
    else:
        leg = _jax_leg(lam, attach)
    env = leg.pop("env")
    return leg, tuple(logs[0].commands), end_state(env)


@pytest.mark.parametrize("lam", [2.0, 0.0], ids=["risk-aware", "risk-blind"])
def test_storm_leg_matches_jax(lam):
    got, got_cmds, got_end = storm_leg(PORT, lam)
    want, want_cmds, want_end = storm_leg(JAX, lam)
    assert got_cmds == want_cmds
    assert got == want
    assert got_end == want_end
    assert got["pods_bound"] == STORM["n_nodes"] * 3
    assert got["pods_lost_with_lead"] == 0
    assert "InterruptionDrain" in {c[0] for c in got_cmds}


def test_storm_holds_the_three_gates():
    aware, _, _ = storm_leg(PORT, 2.0)
    blind, _, _ = storm_leg(PORT, 0.0)
    gates = mod(PORT, "workload").spot_gates(aware, blind, STORM["n_nodes"])
    assert gates["cost_beats_blind"] is True
    assert gates["churn_bound_ok"] is True
    assert gates["zero_late_drain_ok"] is True
    # the blind leg actually rode the storm
    assert blind["notices"] > aware["notices"]
