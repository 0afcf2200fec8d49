"""The port's engine ladder against the JAX package's.

Each case builds the same inputs twice from one seed, once with each
package's own objects (or feeds one numpy argument dict to both), the
shapes of ``tests/test_native_solver.py``'s four classes:

- **The native engine**: the port's ``native.solve_step`` and
  ``solve_probe_batch`` equal the JAX package's bit for bit on identical
  arguments (seeded kernel-argument families, tensorized snapshots); the
  batched probe entry equals its per-row solves; the port's
  ``NativeSolver`` makes the JAX ``NativeSolver``'s claims and errors on
  the basic scenarios and a seeded random mix, and stays within the FFD
  oracle's node-count gate. Against the port's plain ``solve_step`` on
  the CPU it gives the same feasibility ``F`` and, on the workload
  shapes, the same nodes and pods placed per group; the per-cell
  ``assign`` split differs by design (the engine fills emptiest-first
  with a priority scan, the device with its level search), as it does in
  the JAX package.
- **The gates**: with ``KARPENTER_NATIVE_CUTOFF=192`` (and
  ``KARPENTER_ASSUME_ACCELERATOR=1`` where the JAX test pins it) set for
  both packages, every batch takes the JAX package's engine and route
  (host loop, small batch, work floor, many groups kept on the device,
  cutoff 0 and work gate 0 turning routing off) and the same claims on
  every rung, the device rung included (its 200-signature shape meets a
  float tie that the pack loop decides as XLA's fused multiply-add does).
- **The probe's native chunks**: ``dispatch_counterfactual_rows_native``
  equals the JAX package's on the probe snapshots of
  ``test_torch_probe.py``; ``DisruptionSnapshot.dispatch`` takes it under
  the gates, and a native failure takes the device rows.
- **Routed loops**: a 24-node storm (6 rounds, seed 7, as
  ``test_torch_interruption.py`` runs it) and the config-4 fleet's
  convergence, routing on in both packages: the same command log, end
  state and engine per solve.
- The port's library is built under ``build/``, never next to the JAX
  package's; ``make_solver`` and ``NativeSolver`` follow the port's device
  rule; an ``Environment(solver=HostSolver())`` round ends where the JAX
  package's does.

Tolerance: exact for every integer, route and decision.
"""

from __future__ import annotations

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu import native as jnative
from karpenter_tpu.models.solver import TPUSolver
from karpenter_tpu_torch import native as tnative
from karpenter_tpu_torch.models.solver import TorchSolver
from karpenter_tpu_torch.ops import consolidate as tcons
from karpenter_tpu_torch.ops import kernels as tkernels
from tests.test_torch_kernels import FAMILIES, make_args
from tests.test_torch_operator import (
    JAX,
    PORT,
    CommandLog,
    Kit,
    config4_env,
    converge,
    end_state,
    mod,
)

ROOT = Path(__file__).resolve().parent.parent
OUTPUTS = ("assign", "assign_e", "used", "tmpl", "F")


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not (tnative.available() and jnative.available()):
        pytest.skip("native toolchain (g++) unavailable")


def assert_same_outputs(want: dict, got: dict):
    for key in OUTPUTS:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


# ---------------------------------------------------------------------------
# the native engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_native_solve_step_matches_jax(family):
    args = make_args(family, seed=300 + FAMILIES.index(family))
    for max_bins in (4, 24):
        try:
            want = jnative.solve_step(dict(args), max_bins)
        except ValueError as e:  # a family the engine refuses
            with pytest.raises(ValueError, match=str(e).split(":")[0]):
                tnative.solve_step(dict(args), max_bins)
            return
        got = tnative.solve_step(dict(args), max_bins)
        assert_same_outputs(want, got)
        assert got["assign"].sum() + got["assign_e"].sum() > 0


def _workload_args(n_pods, n_types):
    """The numpy ``kernel_args`` and ``Bp`` of a ``build_workload`` solve,
    as ``TorchSolver`` builds them."""
    from karpenter_tpu_torch.ops.tensorize import kernel_args, tensorize
    from karpenter_tpu_torch.workload import build_workload

    pods, templates, its = build_workload(n_pods, n_types)
    templates = sorted(templates, key=lambda t: (-t.weight, t.nodepool_name))
    snap = tensorize(pods, templates, its)
    p = TorchSolver(device="cpu").plan(snap)
    return kernel_args(snap, Gp=p["Gp"], Tp=p["Tp"]), p


@pytest.mark.parametrize("n_pods,n_types", [(100, 60), (2000, 60),
                                            (3000, 200)])
def test_native_against_the_plain_path_on_workloads(n_pods, n_types):
    """The same feasibility, bins, templates and pods per group as the
    port's plain ``solve_step``; and bit-equal to the JAX engine."""
    args, p = _workload_args(n_pods, n_types)
    got = tnative.solve_step(args, p["Bp"])
    assert_same_outputs(jnative.solve_step(args, p["Bp"]), got)
    plain = {k: v.numpy() for k, v in tkernels.solve_step(
        tkernels.from_kernel_args(args, "cpu"), max_bins=p["Bp"],
        level_bits=p["level_bits"], max_minv=p["max_minv"]).items()}
    assert np.array_equal(got["F"], plain["F"])
    assert np.array_equal(got["used"], plain["used"])
    assert np.array_equal(got["tmpl"][got["used"]],
                          plain["tmpl"][plain["used"]])
    assert np.array_equal(got["assign"].sum(1), plain["assign"].sum(1))
    assert int(got["assign"].sum()) == n_pods


def _probe_inputs(pkg):
    """``TestProbeBatchEntry``'s shared snapshot, built by ``pkg``."""
    tz = importlib.import_module(f"{pkg}.ops.tensorize")
    k = Kit(pkg)
    pool = k.nodepool()
    cat = mod(pkg, "cloudprovider.catalog").benchmark_catalog(24)
    pods = [k.pod(f"p{i}", cpu=0.25 + (i % 5) * 0.5) for i in range(60)]
    templates = [mod(pkg, "models").ClaimTemplate(pool)]
    snap = tz.tensorize(pods, templates, {pool.name: cat})
    Gp, Tp = tz.bucket(snap.G), tz.bucket(snap.T)
    shared = tz.kernel_args(snap, None, Gp=Gp, Tp=Tp, include_counts=False)
    E, R = 5, len(snap.resources)
    shared.update(
        ge_ok=np.ones((Gp, E), dtype=bool),
        e_npods=np.zeros(E, dtype=np.int32),
        e_scnt=np.zeros((E, shared["g_sown"].shape[1]), dtype=np.int32),
        e_decl=np.zeros((E, shared["g_decl"].shape[1]), dtype=np.uint32),
        e_match=np.zeros((E, shared["g_decl"].shape[1]), dtype=np.uint32),
        e_aff=np.zeros((E, shared["g_aneed"].shape[1]), dtype=np.int32),
    )
    return shared, snap.G, Gp, E, R


def test_probe_batch_matches_per_row_and_jax():
    shared, G, Gp, E, R = _probe_inputs(PORT)
    shared_j = _probe_inputs(JAX)[0]
    assert sorted(shared) == sorted(shared_j)
    for key in shared:
        assert np.array_equal(shared[key], shared_j[key]), key
    rng = np.random.RandomState(3)
    N = 23
    g_rows = rng.randint(0, 6, size=(N, Gp)).astype(np.int32)
    g_rows[:, G:] = 0
    e_rows = (rng.rand(N, E, R) * 6).astype(np.float32)
    for max_bins in (1, 4):
        ref_pg = np.zeros((N, Gp), dtype=np.int64)
        ref_used = np.zeros(N, dtype=np.int64)
        for i in range(N):
            args = dict(shared, g_count=g_rows[i], e_avail=e_rows[i])
            out = tnative.solve_step(args, max_bins)
            ref_pg[i] = out["assign"].sum(axis=1) + out["assign_e"].sum(axis=1)
            ref_used[i] = out["used"].sum()
        pg, used = tnative.solve_probe_batch(shared, g_rows, e_rows, max_bins)
        assert (pg == ref_pg).all() and (used == ref_used).all()
        jpg, jused = jnative.solve_probe_batch(shared_j, g_rows, e_rows,
                                               max_bins)
        assert np.array_equal(pg, jpg) and np.array_equal(used, jused)


def test_probe_batch_row_count_mismatch_rejected():
    shared, G, Gp, E, R = _probe_inputs(PORT)
    with pytest.raises(ValueError, match="row-count mismatch"):
        tnative.solve_probe_batch(
            shared, np.zeros((2, Gp), dtype=np.int32),
            np.zeros((3, E, R), dtype=np.float32), 1)


def _basic(k, cat, scenario):
    """One scenario of ``TestNativeBasics``: (pods, pools, catalog,
    limits)."""
    wk = k.wk
    pods, pools, limits = [k.pod("p1")], [k.nodepool()], None
    if scenario == "pack":
        pods = [k.pod(f"p{i}", cpu=0.5, mem_gib=1.0) for i in range(40)]
    elif scenario == "selector_groups":
        cat = [k.make_instance_type(n, c, m, arch=a) for n, c, m, a in (
            ("small-amd", 2, 8, "amd64"), ("small-arm", 2, 8, "arm64"),
            ("medium-amd", 8, 32, "amd64"), ("medium-arm", 8, 32, "arm64"))]
        pods = [k.pod(f"a{i}", node_selector={wk.ARCH_LABEL: "amd64"})
                for i in range(6)]
        pods += [k.pod(f"b{i}", node_selector={wk.ARCH_LABEL: "arm64"})
                 for i in range(6)]
    elif scenario == "arch_mismatch":
        pods = [k.pod(f"b{i}", node_selector={wk.ARCH_LABEL: "arm64"})
                for i in range(3)]
    elif scenario == "zone":
        pods = [k.pod("p1", node_selector={wk.TOPOLOGY_ZONE_LABEL: "zone-2"})]
    elif scenario in ("taint", "toleration"):
        taint = k.Taint(key="team", value="a", effect="NoSchedule")
        pools = [k.nodepool("tainted", taints=[taint])]
        if scenario == "toleration":
            pods = [k.pod("p2", tolerations=[k.Toleration(
                key="team", operator="Equal", value="a",
                effect="NoSchedule")])]
    elif scenario == "unschedulable":
        pods = [k.pod("huge", cpu=512.0)]
    elif scenario == "weights":
        pools = [k.nodepool("low"), k.nodepool("high")]
        pools[0].spec.weight, pools[1].spec.weight = 1, 50
    elif scenario == "limits":
        pools[0].spec.limits = {"cpu": 4.0}
        limits = {"default": {"cpu": 4.0}}
        pods = [k.pod(f"p{i}", cpu=1.5) for i in range(10)]
    elif scenario == "random_mix":
        import random

        rng = random.Random(7)
        cat = mod(k.pkg, "cloudprovider.catalog").benchmark_catalog(60)
        pods = []
        for i in range(300):
            cpu = rng.choice([0.25, 0.5, 1.0, 2.0, 4.0])
            sel = rng.choice([
                {}, {wk.ARCH_LABEL: "amd64"}, {wk.ARCH_LABEL: "arm64"},
                {wk.CAPACITY_TYPE_LABEL: "spot"}])
            pods.append(k.pod(f"p{i}", cpu=cpu, mem_gib=cpu * 2,
                              node_selector=dict(sel)))
    return pods, pools, cat, limits


BASIC = ["single", "pack", "selector_groups", "arch_mismatch", "zone",
         "taint", "toleration", "unschedulable", "weights", "limits",
         "random_mix"]


def _claims(res) -> tuple:
    claims = sorted(
        (c.template.nodepool_name, tuple(sorted(p.name for p in c.pods)),
         tuple(sorted(it.name for it in c.instance_types)))
        for c in res.new_claims)
    return claims, sorted(res.pod_errors)


def _solve_basic(pkg, scenario, solver_name):
    k = Kit(pkg)
    cat = [k.make_instance_type(*t) for t in (
        ("small", 2, 8), ("medium", 8, 32), ("large", 32, 128))]
    pods, pools, cat, limits = _basic(k, cat, scenario)
    models = mod(pkg, "models")
    templates = [models.ClaimTemplate(p) for p in pools]
    solver = getattr(models, solver_name)
    solver = solver(device="cpu") if (
        pkg == PORT and solver_name == "NativeSolver") else solver()
    kw = {"limits": limits} if limits else {}
    res = solver.solve([p.clone() for p in pods], templates,
                       {p.name: cat for p in pools}, **kw)
    return res, solver


@pytest.mark.parametrize("scenario", BASIC)
def test_native_solver_matches_jax(scenario):
    got, solver = _solve_basic(PORT, scenario, "NativeSolver")
    want, _ = _solve_basic(JAX, scenario, "NativeSolver")
    assert _claims(got) == _claims(want)
    stats = solver.last_device_stats
    if stats["engine"] != "host":  # the host cutoff takes ≤ 8 pods first
        assert stats["engine"] == "native"
        assert _last_route() == ("native", "ok")
    host, _ = _solve_basic(PORT, scenario, "HostSolver")
    # BASELINE parity gate: ≤2% node-count overhead vs the FFD oracle
    assert got.node_count() <= max(host.node_count() * 1.02,
                                   host.node_count() + 1)
    if scenario in ("single", "pack", "selector_groups", "zone",
                    "toleration", "random_mix"):
        assert not got.pod_errors and got.scheduled_pod_count() > 0
    if scenario == "weights":
        assert got.new_claims[0].template.nodepool_name == "high"
    if scenario == "limits":
        assert sum(max(it.capacity["cpu"] for it in c.instance_types)
                   for c in got.new_claims) <= 4.0 + 1e-6


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------


def _last_route() -> tuple:
    """The port's last ``solver.route`` verdict on its decision ledger."""
    from karpenter_tpu_torch.obs import decisions

    last = decisions.DECISIONS.site_summary()["solver.route"]["last"]
    return last["rung"], last["reason"]


def _jax_route(solver) -> tuple:
    """The JAX solver's (engine, route) in the port's names: its device
    rung is ``xla`` and its engine ``device``; a host-routed solve names
    its reason in ``host_routed``."""
    stats = solver.last_device_stats
    if stats["engine"] == "host":
        return "host", ("host", next(iter(stats["host_routed"])))
    rung, reason = solver._route
    return (stats["engine"].replace("device", "cpu"),
            (rung.replace("xla", "device"), reason))


ROUTING = {
    # name: (env, n pods, cpu of pod i, catalog, engine, route)
    "tiny_batch_host_loop": ({}, 1, lambda i: 1.0, 3, "host",
                             ("host", "small-batch")),
    "small_batch": ({}, 10, lambda i: 1.0, 3, "native",
                    ("native", "small-batch")),
    "tiny_catalog": ({}, 300, lambda i: 1.0, 3, "native",
                     ("native", "work-floor")),
    "moderate_groups_under_work_floor": (
        {}, 1000, lambda i: 0.1 + (i % 50) * 0.05, 100, "native",
        ("native", "work-floor")),
    "many_groups_keep_device": (
        {"KARPENTER_ASSUME_ACCELERATOR": "1"}, 400,
        lambda i: 0.1 + (i % 200) * 0.01, 64, "cpu", ("device", "ok")),
    "many_groups_cpu_backend": (
        {}, 400, lambda i: 0.1 + (i % 200) * 0.01, 64, "native",
        ("native", "cpu-backend")),
    "work_gate_zero": ({"KARPENTER_DEVICE_MIN_WORK": "0",
                        "KARPENTER_ASSUME_ACCELERATOR": "1"}, 1000,
                       lambda i: 1.0, 3, "cpu", ("device", "ok")),
    "cutoff_zero": ({"KARPENTER_NATIVE_CUTOFF": "0"}, 10, lambda i: 1.0, 3,
                    "cpu", ("device", "ok")),
}


def _routed(pkg, n, cpu, n_types):
    k = Kit(pkg)
    if n_types == 3:
        cat = [k.make_instance_type(*t) for t in (
            ("small", 2, 8), ("medium", 8, 32), ("large", 32, 128))]
    else:
        cat = mod(pkg, "cloudprovider.catalog").benchmark_catalog(n_types)
    pool = k.nodepool()
    solver = TorchSolver(device="cpu") if pkg == PORT else TPUSolver()
    res = solver.solve([k.pod(f"p{i}", cpu=cpu(i)) for i in range(n)],
                       [mod(pkg, "models").ClaimTemplate(pool)],
                       {pool.name: cat})
    return res, solver


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_gates_route_like_jax(case, monkeypatch):
    env, n, cpu, n_types, engine, route = ROUTING[case]
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "192")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got, solver = _routed(PORT, n, cpu, n_types)
    want, jsolver = _routed(JAX, n, cpu, n_types)
    stats = solver.last_device_stats
    assert (stats["engine"], _last_route()) == (engine, route)
    assert solver._route in (None, route)
    assert _jax_route(jsolver) == (engine, route)
    assert got.node_count() == want.node_count()
    assert got.scheduled_pod_count() == want.scheduled_pod_count() == n
    assert _claims(got) == _claims(want)


def test_routed_batch_keeps_its_decision(monkeypatch):
    """A routed small batch opens the nodes the device would
    (``test_small_batch_parity_native_vs_device``)."""
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "192")
    routed, solver = _routed(PORT, 40, lambda i: 0.5 + (i % 3) * 0.5, 3)
    assert solver.last_device_stats["engine"] == "native"
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "0")
    direct, solver = _routed(PORT, 40, lambda i: 0.5 + (i % 3) * 0.5, 3)
    assert solver.last_device_stats["engine"] == "cpu"
    assert routed.node_count() == direct.node_count()
    assert routed.scheduled_pod_count() == direct.scheduled_pod_count() == 40


def test_native_failure_takes_the_device(monkeypatch, caplog):
    """A native engine fault is logged and the dispatch runs on the
    solver's device, with the device's answer."""
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "192")

    def broken(args, max_bins):
        raise RuntimeError("native engine failed: rc=3")

    monkeypatch.setattr(tnative, "solve_step", broken)
    got, solver = _routed(PORT, 40, lambda i: 0.5 + (i % 3) * 0.5, 3)
    assert solver.last_device_stats["engine"] == "cpu"
    assert _last_route() == ("device", "ok") == solver._route
    assert "falling back to the device kernel" in caplog.text
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "0")
    direct, _ = _routed(PORT, 40, lambda i: 0.5 + (i % 3) * 0.5, 3)
    assert _claims(got) == _claims(direct)


def test_native_solve_never_uploads(monkeypatch):
    """A routed solve builds no device tensors: the gate reads the numpy
    arguments."""
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "192")
    uploads = []
    real = tkernels.from_kernel_args
    monkeypatch.setattr(tkernels, "from_kernel_args",
                        lambda *a, **kw: uploads.append(1) or real(*a, **kw))
    _, solver = _routed(PORT, 40, lambda i: 1.0, 3)
    assert solver.last_device_stats["engine"] == "native"
    assert uploads == []


# ---------------------------------------------------------------------------
# the probe's native chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,max_bins,rows", [
    ("first_then_claims", 1, 130), ("random_mix", 2, 24),
    ("spread_seeded", 1, 12), ("anti_declarer", 2, 12)])
def test_native_probe_chunks_match_jax(name, max_bins, rows):
    from karpenter_tpu.ops import consolidate as jcons
    from tests.test_torch_probe import counterfactual_rows, snapshot

    shared_j, Gp, Ep, e_avail, max_minv, G, E, _ = snapshot(JAX, name)
    shared_t = snapshot(PORT, name)[0]
    rng = np.random.default_rng(len(name) + rows)
    g_count, cols, free = counterfactual_rows(rng, G, E, rows,
                                              free_share=0.25,
                                              R=e_avail.shape[1])
    want = jcons.dispatch_counterfactual_rows_native(
        shared_j, Gp, Ep, e_avail, max_minv, g_count, cols, e_free=free,
        max_bins=max_bins)
    got = tcons.dispatch_counterfactual_rows_native(
        shared_t, Gp, Ep, e_avail, max_minv, g_count, cols, e_free=free,
        max_bins=max_bins)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0].sum() > 0


def _fleet_bundle():
    from karpenter_tpu_torch.workload import underutilized_fleet

    store, cluster, prov, cands = underutilized_fleet(24, device="cpu")
    bundle = tcons.build_disruption_snapshot(prov, cluster, store, cands)
    cols = [np.asarray([bundle.col_by_pid[c.provider_id]
                        for c in cands[:k + 1]]) for k in range(len(cands))]
    g_count = (bundle.base[None, :] + np.cumsum(
        bundle.contribs_for(cands), axis=0)).astype(np.int32)
    return bundle, g_count, cols


def test_bundle_dispatch_routes_native_under_the_gate(monkeypatch, caplog):
    """The fleet's snapshot (G×T under the work floor) dispatches through
    the native probe entry with routing on, through ``probe_step`` with
    it off, and falls back to the device rows when the engine fails —
    with the same answers every time."""
    bundle, g_count, cols = _fleet_bundle()
    calls = {"native": 0, "device": 0}
    real_native = tcons.dispatch_counterfactual_rows_native
    real_device = tcons.dispatch_counterfactual_rows

    def count(kind, real):
        def fn(*a, **kw):
            calls[kind] += 1
            return real(*a, **kw)
        return fn

    monkeypatch.setattr(tcons, "dispatch_counterfactual_rows_native",
                        count("native", real_native))
    monkeypatch.setattr(tcons, "dispatch_counterfactual_rows",
                        count("device", real_device))
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "0")
    device = bundle.dispatch(g_count, cols, max_bins=2)
    assert calls == {"native": 0, "device": 1}
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "192")
    assert bundle.snap.G * bundle.snap.T < 8192
    routed = bundle.dispatch(g_count, cols, max_bins=2)
    assert calls == {"native": 1, "device": 1}
    for a, b in zip(device, routed):
        assert np.array_equal(a, b)
    assert device[0].sum() > 0

    def broken(*a, **kw):
        raise RuntimeError("native probe batch failed: rc=3")

    monkeypatch.setattr(tnative, "solve_probe_batch", broken)
    fallback = bundle.dispatch(g_count, cols, max_bins=2)
    assert calls == {"native": 2, "device": 2}
    assert "using the device kernel" in caplog.text
    for a, b in zip(device, fallback):
        assert np.array_equal(a, b)
    monkeypatch.setenv("KARPENTER_DEVICE_MIN_WORK", "1")
    bundle.dispatch(g_count, cols, max_bins=2)
    assert calls == {"native": 2, "device": 3}


# ---------------------------------------------------------------------------
# routed loops: the storm and the config-4 convergence
# ---------------------------------------------------------------------------


def _engines(monkeypatch, cls, seen):
    real = cls.solve

    def solve(self, *a, **kw):
        out = real(self, *a, **kw)
        seen.append(self.last_device_stats["engine"].replace(
            "device", "cpu"))
        return out

    monkeypatch.setattr(cls, "solve", solve)


@pytest.fixture
def routing_on(monkeypatch):
    monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "192")
    monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")
    return monkeypatch


def test_routed_storm_matches_jax(routing_on):
    from tests.test_torch_interruption import STORM, _jax_leg

    legs = {}
    for pkg in (JAX, PORT):
        seen, logs = [], []
        _engines(routing_on, TPUSolver if pkg == JAX else TorchSolver, seen)
        if pkg == JAX:
            leg = _jax_leg(0.0, lambda env: logs.append(CommandLog(env)))
        else:
            s = dict(STORM)
            leg = mod(PORT, "workload").spot_storm(
                s.pop("n_nodes"), lam=0.0, solver=TorchSolver(device="cpu"),
                on_env=lambda env: logs.append(CommandLog(env)), **s)
        env = leg.pop("env")
        legs[pkg] = (leg, tuple(logs[0].commands), end_state(env), seen)
    got, want = legs[PORT], legs[JAX]
    assert got[1] == want[1]
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert "native" in got[3] and "host" in got[3]
    assert got[0]["pods_bound"] == STORM["n_nodes"] * 3
    assert got[0]["pods_lost_with_lead"] == 0


def test_routed_convergence_matches_jax(routing_on):
    """The config-4 fleet (24 nodes) converges with the same commands,
    rounds and end state, and its probes take the native chunks."""
    from karpenter_tpu.ops import consolidate as jcons

    out = {}
    for pkg, cons in ((JAX, jcons), (PORT, tcons)):
        native_probes = []
        real = cons.dispatch_counterfactual_rows_native
        routing_on.setattr(cons, "dispatch_counterfactual_rows_native",
                           lambda *a, real=real, **kw: native_probes.append(1)
                           or real(*a, **kw))
        env = config4_env(pkg, 24)
        log = CommandLog(env)
        start = end_state(env)
        rounds = converge(env)
        out[pkg] = (start, log.commands, rounds, end_state(env),
                    len(native_probes))
    assert out[PORT] == out[JAX]
    start, commands, _, (nodes, unbound, _), n_native = out[PORT]
    assert commands and not unbound and len(nodes) < len(start[0])
    assert n_native > 0


# ---------------------------------------------------------------------------
# the library, the default solvers, the HostSolver repair
# ---------------------------------------------------------------------------


def test_library_is_the_ports_own():
    path = tnative.lib_path()
    assert path.parent == ROOT / "build" / "torch_kernels"
    assert path.exists() and path.name.startswith("libkarpenter_native-")
    assert tnative._lib._name == str(path)
    jax_dir = ROOT / "karpenter_tpu" / "native"
    assert jax_dir not in path.parents
    assert tnative.SRC.read_bytes() == (jax_dir / "kernel.cpp").read_bytes()


def test_native_cache_knob_moves_the_library(monkeypatch, tmp_path):
    monkeypatch.setenv("KARPENTER_NATIVE_CACHE", str(tmp_path))
    path = tnative.lib_path()
    assert path.parent == tmp_path
    assert tnative._build(path) and path.exists()


def test_default_solvers_follow_the_device_rule(monkeypatch):
    from karpenter_tpu_torch.controllers.provisioning.provisioner import (
        Provisioner,
    )
    from karpenter_tpu_torch.models import (
        HostSolver,
        NativeSolver,
        make_solver,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (make_solver, NativeSolver, TorchSolver,
                  lambda: Provisioner(None, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    solver = make_solver(prefer_device=False)
    assert type(solver) is NativeSolver and solver.device.type == "cpu"
    monkeypatch.setattr(tnative, "available", lambda: False)
    assert type(make_solver(prefer_device=False)) is HostSolver


def test_host_solver_round_matches_jax(monkeypatch):
    """``Environment(solver=HostSolver())``: the provisioner passes
    ``existing_base=``, which the host loop takes and ignores, and the
    fleet consolidates as the JAX package's does."""
    from tests import test_torch_operator as top

    out = {}
    for pkg in (JAX, PORT):
        monkeypatch.setattr(
            Kit, "solver", lambda self: mod(self.pkg, "models").HostSolver())
        env = top._fleet_env(pkg, [(5.0, 3, 1)] * 9)
        log = CommandLog(env)
        start = end_state(env)
        rounds = converge(env)
        out[pkg] = (start, log.commands, rounds, end_state(env))
    assert out[PORT] == out[JAX]
    start, commands, _, (nodes, unbound, _) = out[PORT]
    assert len(start[0]) == 9 and len(nodes) == 3 and not unbound
    assert commands
