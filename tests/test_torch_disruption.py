"""The port's disruption loop against the JAX package's.

Each case is built twice, each time with one package's own objects and
driven through that package's ``Environment`` (the JAX package with
``TPUSolver`` on the CPU, the port with ``TorchSolver(device="cpu")``);
the harness is ``tests/test_torch_operator.py``'s.

- **The shapes of ``tests/test_disruption.py``**: emptiness after its
  TTL, empty-node consolidation, single-node delete, replace with a
  cheaper type, a zero budget, do-not-disrupt, a PDB, and a nodepool
  drift replaced.
- **The config-4 fleet at 24 nodes and the seeded mixed fleet of
  ``tests/test_global_consolidation.py`` at three seeds** (several pod
  groups), each converged as ``perf/run.py`` does with
  ``KARPENTER_GLOBAL_CONSOLIDATION`` 1 and 0, and with
  ``KARPENTER_RELAX=1``.

In both, every command the controller executes is the same in both
packages — method, rung (the global verdict and its reason, the ladder
probes' kind), action, candidates by creation order, replacement types —
and so is the end state: nodes with their pods by owner, unbound pods,
the fleet's hourly price. No probe falls back for a failure.

- **The snapshot across an eviction wave**: a ``SnapshotCache`` bundle
  advanced by the cluster's delta journal through a consolidation wave
  equals a fresh build of the same generation, tensor for tensor (by
  provider id), and its counterfactual rows dispatch to the same
  answers; the wave really advanced, never rebuilt.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.test_torch_operator import (
    JAX,
    PORT,
    CommandLog,
    Kit,
    config4_env,
    converge,
    end_state,
    mixed_env,
    mod,
)

GIB = 2**30


def _live(env):
    return [n for n in env.store.list("nodes")
            if n.metadata.deletion_timestamp is None]


def _pod_template(k, name, cpu=0.7, labels=None):
    return k.Pod(metadata=k.ObjectMeta(name=name,
                                       labels=labels or {"app": name}),
                 requests={"cpu": cpu, "memory": 0.25 * GIB})


def _deployment(k, name, replicas, cpu=0.7, labels=None):
    return k.Deployment(metadata=k.ObjectMeta(name=name), replicas=replicas,
                        template=_pod_template(k, name, cpu, labels))


def _delete_pods(env, pred=lambda p: True):
    for p in list(env.store.list("pods")):
        if pred(p) and p.metadata.deletion_timestamp is None:
            env.store.delete("pods", p)


def _emptiness_after_ttl(k):
    env = k.env([("small", 2, 8)], enable_disruption=True)
    log = CommandLog(env)
    np_ = k.nodepool()
    np_.spec.disruption.consolidation_policy = k.WHEN_EMPTY
    np_.spec.disruption.consolidate_after = 30.0
    env.create("nodepools", np_)
    (p,) = env.provision(_pod_template(k, "p1"))
    env.store.delete("pods", p)
    env.run_until_idle()
    assert len(_live(env)) == 1  # inside the TTL
    env.clock.step(31.0)
    env.run_until_idle()
    return env, log


def _disruption_env(k):
    env = k.env([("small", 2, 8), ("medium", 8, 32)], enable_disruption=True)
    return env, CommandLog(env)


def _empty_node_consolidation(k):
    env, log = _disruption_env(k)
    env.create("nodepools", k.nodepool())
    d = _deployment(k, "a", 1)
    env.create("deployments", d)
    env.run_until_idle()
    d.replicas = 0
    env.store.update("deployments", d)
    _delete_pods(env)
    env.run_until_idle()
    return env, log


def _two_nodes(k, env):
    env.create("nodepools", k.nodepool())
    a = _deployment(k, "a", 2)
    env.create("deployments", a)
    env.run_until_idle()
    b = _deployment(k, "b", 1)
    env.create("deployments", b)
    env.run_until_idle()
    return a, b


def _single_node_delete(k):
    env, log = _disruption_env(k)
    a, _ = _two_nodes(k, env)
    a.replicas = 1
    env.store.update("deployments", a)
    pods_a = [p for p in env.store.list("pods")
              if p.metadata.labels.get("app") == "a"
              and p.metadata.deletion_timestamp is None]
    env.store.delete("pods", pods_a[0])
    env.run_until_idle()
    return env, log


def _replace_cheaper(k):
    env = k.env([("small", 2, 8), ("large", 16, 64)], enable_disruption=True)
    log = CommandLog(env)
    env.create("nodepools", k.nodepool(requirements=[
        k.NodeSelectorRequirement(k.wk.CAPACITY_TYPE_LABEL, "In",
                                  [k.wk.CAPACITY_TYPE_ON_DEMAND])]))
    big = _deployment(k, "big", 1, cpu=10.0)
    env.create("deployments", big)
    env.run_until_idle()
    big.replicas = 0
    env.store.update("deployments", big)
    _delete_pods(env, lambda p: p.metadata.labels.get("app") == "big")
    env.create("deployments", _deployment(k, "small", 1, cpu=0.5))
    env.run_until_idle()
    return env, log


def _budget_zero(k):
    env, log = _disruption_env(k)
    env.create("nodepools", k.nodepool())
    env.store.list("nodepools")[0].spec.disruption.budgets = [
        k.Budget(nodes="0")]
    d = _deployment(k, "a", 1)
    env.create("deployments", d)
    env.run_until_idle()
    d.replicas = 0
    env.store.update("deployments", d)
    _delete_pods(env)
    env.run_until_idle()
    return env, log


def _do_not_disrupt(k):
    env, log = _disruption_env(k)
    env.create("nodepools", k.nodepool())
    p = _pod_template(k, "p1")
    p.metadata.annotations[k.wk.DO_NOT_DISRUPT_ANNOTATION] = "true"
    env.provision(p)
    env.run_until_idle()
    return env, log


def _pdb(k):
    env, log = _disruption_env(k)
    env.create("nodepools", k.nodepool())
    env.create("pdbs", k.PodDisruptionBudget(
        metadata=k.ObjectMeta(name="pdb-a"),
        selector=k.LabelSelector(match_labels={"app": "a"}),
        max_unavailable=0))
    a = _deployment(k, "a", 2, labels={"app": "a"})
    env.create("deployments", a)
    env.run_until_idle()
    env.create("deployments", _deployment(k, "b", 1, labels={"app": "a"}))
    env.run_until_idle()
    a.replicas = 1
    env.store.update("deployments", a)
    pods_a = [p for p in env.store.list("pods")
              if p.metadata.name.startswith("a-")
              and p.metadata.deletion_timestamp is None]
    env.store.delete("pods", pods_a[0])
    env.run_until_idle()
    return env, log


def _drift_replace(k):
    env, log = _disruption_env(k)
    env.create("nodepools", k.nodepool())
    env.create("deployments", _deployment(k, "a", 1))
    env.run_until_idle()
    np_ = env.store.list("nodepools")[0]
    np_.spec.template.labels["team"] = "blue"
    env.store.update("nodepools", np_)
    env.run_until_idle()
    return env, log


SHAPES = {
    "emptiness-after-ttl": (_emptiness_after_ttl, 0),
    "empty-node-consolidation": (_empty_node_consolidation, 0),
    "single-node-delete": (_single_node_delete, 1),
    "replace-cheaper": (_replace_cheaper, 1),
    "budget-zero": (_budget_zero, 1),
    "do-not-disrupt": (_do_not_disrupt, 1),
    "pdb": (_pdb, 2),
    "drift-replace": (_drift_replace, 1),
}


def _probe_failures(env):
    m = mod(PORT, "operator.metrics")
    ctr = env.registry.counter(m.DISRUPTION_PROBE_FAILURES)
    return sum(ctr.value(method=x) for x in ("global", "multi", "single"))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_disruption_shapes_match_jax(shape):
    build, nodes = SHAPES[shape]
    want_env, want_log = build(Kit(JAX))
    got_env, got_log = build(Kit(PORT))
    assert got_log.commands == want_log.commands
    assert end_state(got_env) == end_state(want_env)
    assert len(_live(got_env)) == nodes
    assert _probe_failures(got_env) == 0
    if shape == "replace-cheaper":
        (node,) = _live(got_env)
        assert node.labels[Kit(PORT).wk.INSTANCE_TYPE_LABEL] == "small"
        assert got_log.commands[-1][2] == "replace"
    if shape == "drift-replace":
        (node,) = _live(got_env)
        assert node.labels.get("team") == "blue"
        assert got_log.commands[0][0] == "Drift"


FLEETS = {
    "config4-24": lambda pkg: config4_env(pkg, 24),
    "mixed-seed0": lambda pkg: mixed_env(pkg, 12, 0),
    "mixed-seed1": lambda pkg: mixed_env(pkg, 12, 1),
    "mixed-seed2": lambda pkg: mixed_env(pkg, 12, 2),
}
KNOBS = {
    "global": {"KARPENTER_GLOBAL_CONSOLIDATION": "1", "KARPENTER_RELAX": "0"},
    "ladder": {"KARPENTER_GLOBAL_CONSOLIDATION": "0", "KARPENTER_RELAX": "0"},
    "relax": {"KARPENTER_GLOBAL_CONSOLIDATION": "1", "KARPENTER_RELAX": "1"},
}


def _converged(pkg, fleet):
    env = FLEETS[fleet](pkg)
    log = CommandLog(env)
    start = end_state(env)
    rounds = converge(env)
    return env, log, start, rounds


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_fleet_converges_like_jax(fleet, knobs, monkeypatch):
    for name, value in KNOBS[knobs].items():
        monkeypatch.setenv(name, value)
    want_env, want_log, want_start, want_rounds = _converged(JAX, fleet)
    got_env, got_log, got_start, got_rounds = _converged(PORT, fleet)
    assert got_start == want_start  # the loop built the same fleet
    assert got_log.commands == want_log.commands
    assert got_rounds == want_rounds
    nodes, unbound, cost = end_state(got_env)
    assert (nodes, unbound, cost) == end_state(want_env)
    assert not unbound
    assert cost < got_start[2] and len(nodes) < len(got_start[0])
    assert _probe_failures(got_env) == 0
    methods = {c[0] for c in got_log.commands}
    if knobs == "ladder":
        assert "GlobalConsolidation" not in methods
    elif fleet == "config4-24":
        assert got_log.commands[0][:3] == (
            "GlobalConsolidation",
            "joint/relax-rounded" if knobs == "relax" else "joint/ok",
            "delete")


# ---------------------------------------------------------------------------
# the snapshot across an eviction wave
# ---------------------------------------------------------------------------

ESNAP_FIELDS = ("e_avail", "e_npods", "e_scnt", "e_decl", "e_match", "e_aff")


def _assert_same_snapshot(adv, fresh):
    assert adv.generation == fresh.generation
    np.testing.assert_array_equal(adv.base, fresh.base)
    assert ({p.uid for p in adv.pending} == {p.uid for p in fresh.pending})
    assert ({p.uid for p in adv.deleting_pods}
            == {p.uid for p in fresh.deleting_pods})
    for name in ("g_demand", "g_mask", "t_alloc", "t_mask"):
        np.testing.assert_array_equal(getattr(adv.snap, name),
                                      getattr(fresh.snap, name))
    ea, ef = adv.esnap, fresh.esnap
    live = {n.state_node.provider_id: r for r, n in enumerate(ea.nodes)
            if ea.live[r]}
    assert set(live) == set(ef.row_of)
    rows_a = np.array([live[pid] for pid in ef.row_of], dtype=np.intp)
    rows_f = np.array(list(ef.row_of.values()), dtype=np.intp)
    for name in ESNAP_FIELDS:
        np.testing.assert_array_equal(getattr(ea, name)[rows_a],
                                      getattr(ef, name)[rows_f])
    np.testing.assert_array_equal(ea.ge_ok[:, rows_a], ef.ge_ok[:, rows_f])
    # masked rows carry nothing a counterfactual could use
    dead = ~ea.live
    assert not ea.e_avail[dead].any() and not ea.ge_ok[:, dead].any()
    return live


def test_snapshot_advanced_across_an_eviction_wave_equals_a_fresh_build():
    env = config4_env(PORT, 24)
    cons = mod(PORT, "ops.consolidate")
    helpers = mod(PORT, "controllers.disruption.helpers")
    decisions = mod(PORT, "obs.decisions")
    cache = env.disruption.ctx.snapshot_cache
    log = CommandLog(env)
    env.disruption.poll_period = 0.0
    env.clock.step(20.0)
    compared = advanced_rounds = 0
    refusals = []  # every declined delta advance, by cause

    def advances():
        return decisions.counts().get(("snapshot.advance", "delta", "ok"), 0)

    c0 = decisions.counts()
    for _ in range(200):
        before = advances()
        progressed = env._round()
        adv = cache.refresh(env.provisioner, env.cluster, env.store)
        if cache._last_refusal is not None:
            refusals.append(cache._last_refusal)
        if adv is not None and advances() > before:
            advanced_rounds += 1
        if adv is not None and log.commands:
            d = env.disruption
            cands = helpers.get_candidates(d.cluster, d.store, d.cloud,
                                           d.clock, queue=d.queue)
            fresh = cons.build_disruption_snapshot(
                env.provisioner, env.cluster, env.store, cands)
            if fresh is not None:
                live = _assert_same_snapshot(adv, fresh)
                # the same counterfactual rows give the same answers
                pids = [c.provider_id for c in cands
                        if c.provider_id in live
                        and c.provider_id in adv.col_by_pid
                        and c.provider_id in fresh.col_by_pid][:6]
                if len(pids) >= 2:
                    by_pid = {c.provider_id: c for c in cands}
                    sel = [by_pid[p] for p in pids]
                    outs = []
                    for b in (adv, fresh):
                        cols = np.asarray(b.columns_for(sel), np.intp)
                        cum = np.cumsum(b.contribs_for(sel, cols=cols), 0)
                        outs.append(b.dispatch(
                            b.base[None, :] + cum,
                            [cols[: i + 1] for i in range(len(sel))]))
                    for x, y in zip(*outs):
                        np.testing.assert_array_equal(x, y)
                compared += 1
        if not progressed:
            break
    assert log.commands, "no command ran"
    assert compared >= 2 and advanced_rounds >= 2
    rebuilds = {k: n - c0.get(k, 0) for k, n in decisions.counts().items()
                if k[:2] == ("snapshot.advance", "rebuild")
                and n > c0.get(k, 0)}
    assert not refusals and not rebuilds, (refusals, rebuilds)


# ---------------------------------------------------------------------------
# the fault rule: host-side errors fall back, device faults propagate
# ---------------------------------------------------------------------------

FAULT_SITES = {
    # (where the fault is raised, the knobs, the probe-failure label)
    "ladder-probe": ("DisruptionSnapshot.dispatch",
                     {"KARPENTER_GLOBAL_CONSOLIDATION": "0"}, "multi"),
    "joint-plan": ("joint_retirement_plan",
                   {"KARPENTER_GLOBAL_CONSOLIDATION": "1"}, "global"),
    "prewarm": ("SnapshotCache.get",
                {"KARPENTER_GLOBAL_CONSOLIDATION": "1"}, "prewarm"),
}


@pytest.mark.parametrize("fault", ["host-error", "kernel-fault"])
@pytest.mark.parametrize("site", sorted(FAULT_SITES))
def test_probe_fault_rule(site, fault, monkeypatch):
    """A ``NotImplementedError`` (a ``RuntimeError`` subclass) raised in a
    probe, the joint plan or the prewarm is a host-side error: the round
    falls back as the JAX package's does, still ships a command, and the
    failure is counted in ``DISRUPTION_PROBE_FAILURES``. The kernel error
    class of ``ops/cuda_kernels.py`` propagates out of the round."""
    from karpenter_tpu_torch.ops import consolidate as cons
    from karpenter_tpu_torch.ops.cuda_kernels import KernelError

    target, knobs, label = FAULT_SITES[site]
    for name, value in knobs.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("KARPENTER_RELAX", "0")
    env = config4_env(PORT, 24)
    log = CommandLog(env)
    exc = NotImplementedError("host") if fault == "host-error" else (
        KernelError("launch"))

    def raising(*a, **kw):
        raise exc

    owner, _, attr = target.rpartition(".")
    monkeypatch.setattr(getattr(cons, owner) if owner else cons, attr,
                        raising)
    env.disruption.poll_period = 0.0
    env.clock.step(20.0)
    if fault == "kernel-fault":
        with pytest.raises(KernelError):
            env.run_until_idle(max_rounds=400)
        return
    env.run_until_idle(max_rounds=400)
    m = mod(PORT, "operator.metrics")
    failures = env.registry.counter(m.DISRUPTION_PROBE_FAILURES)
    assert failures.value(method=label) >= 1
    assert log.commands, "the round did not fall back to a search"
    nodes, unbound, _ = end_state(env)
    assert not unbound and len(nodes) < 24
