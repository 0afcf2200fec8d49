"""The port's LP relax rungs against the JAX package's.

The bin floor:

Each family builds the same pods and catalog with each package's own
objects from a seed, tensorizes them on each side and runs
``lp_bin_floor`` with ``KARPENTER_RELAX=1`` (the knob the JAX package's
own tests use to turn the floor on off an accelerator). Tolerance: the
integer floor exact; the fractional bound ``lb`` within 1e-4 relative
(an fp32 PDHG of up to 384 iterations, XLA's CPU reductions against
torch's). The ``narrow`` family is one where the floor raises the
demand estimate, so the solver's bin axis depends on it: there the port's
``plan`` must size the axis exactly as ``TPUSolver`` does.

The joint consolidation rung: ``joint_relax_plan`` on seeded pure-numpy
fleets of ``tests/test_relax.py``'s ``_mk_bundle`` shape (rebuilt here),
60 seeds, and on each cause of the fallback matrix forced as that file
forces it. Tolerance: the same ship or fallback cause, the same
``selected_idx`` and displacement, and ``last_k_ub``, exactly; the
continuous LP values (``y``, ``sum(y)``) within 1e-4 relative.

Called with no device, both rungs run on CUDA or raise: never on the
CPU on their own.
"""

import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from karpenter_tpu.models.solver import TPUSolver
from karpenter_tpu.ops import consolidate as jcons
from karpenter_tpu.ops import relax as jrelax
from karpenter_tpu.ops.tensorize import tensorize as jax_tensorize
from karpenter_tpu_torch.models import TorchSolver
from karpenter_tpu_torch.ops import consolidate as tcons
from karpenter_tpu_torch.ops import relax as trelax
from karpenter_tpu_torch.ops.tensorize import tensorize

GIB = 2**30
LB_RTOL = 1e-4
FAMILIES = ["narrow", "seed0", "seed1", "seed2", "seed3", "seed4", "seed5"]


def build(pkg: str, family: str):
    """(pods, templates, instance_types_by_pool) of one family, from the
    package's own objects."""
    objects = importlib.import_module(f"{pkg}.api.objects")
    wk = importlib.import_module(f"{pkg}.api.labels")
    catalog = importlib.import_module(f"{pkg}.cloudprovider.catalog")
    nodepool = importlib.import_module(f"{pkg}.api.nodepool")
    inflight = importlib.import_module(f"{pkg}.models.inflight")

    def pod(name, cpu, mem, sel=None):
        return objects.Pod(metadata=objects.ObjectMeta(name=name),
                           requests={"cpu": cpu, "memory": mem * GIB},
                           node_selector=dict(sel or {}))

    pool = nodepool.NodePool(metadata=objects.ObjectMeta(name="default"))
    if family == "narrow":
        # 200 one-cpu pods pinned to the 4-cpu type: the demand bound over
        # the 32-cpu type says 7 bins, the LP 51 — enough to lift
        # the bin axis above its 64-bin minimum
        its = [catalog.make_instance_type("small", 4, 16),
               catalog.make_instance_type("large", 32, 128)]
        pods = [pod(f"n{i}", 1.0, 1.0, {wk.INSTANCE_TYPE_LABEL: "small"})
                for i in range(200)]
        pods += [pod(f"f{i}", 0.5, 1.0) for i in range(10)]
    else:
        r = random.Random(int(family[4:]))
        its = catalog.benchmark_catalog(r.choice((20, 40, 60)))
        sels = [{}, {wk.ARCH_LABEL: "arm64"}, {wk.ARCH_LABEL: "amd64"},
                {wk.CAPACITY_TYPE_LABEL: "spot"},
                {wk.INSTANCE_TYPE_LABEL: its[r.randrange(len(its))].name}]
        pods = []
        for g in range(r.randrange(3, 12)):
            cpu = r.choice((0.1, 0.25, 0.5, 1.0, 2.0, 4.0))
            mem = r.choice((0.25, 0.5, 1.0, 2.0, 8.0))
            sel = r.choice(sels)
            pods += [pod(f"g{g}-{i}", cpu, mem, sel)
                     for i in range(r.randrange(1, 200))]
    return pods, [inflight.ClaimTemplate(pool)], {pool.name: its}


def snapshots(family):
    jp, jt, jits = build("karpenter_tpu", family)
    tp, tt, tits = build("karpenter_tpu_torch", family)
    return jax_tensorize(jp, jt, jits), tensorize(tp, tt, tits)


def jax_lb(js) -> float:
    """The JAX floor kernel's fractional bound on the JAX snapshot (the
    JAX package's lp_bin_floor keeps it internal)."""
    from karpenter_tpu.ops.consolidate import _group_type_compat

    G, T, R = js.G, js.T, len(js.resources)
    Gp, Tp = jrelax._pow2(G, lo=2), jrelax._pow2(T, lo=2)
    d = np.zeros((Gp, R), np.float32)
    d[:G] = js.g_demand
    n = np.zeros(Gp, np.float32)
    n[:G] = js.g_count
    alloc = np.zeros((Tp, R), np.float32)
    alloc[:T] = np.maximum(js.t_alloc - js.m_overhead[js.t_tmpl], 0.0)
    rscale = 1.0 / np.maximum(np.maximum(alloc.max(0), d.max(0)), 1e-12)
    d *= rscale[None, :]
    alloc *= rscale[None, :]
    cm = np.zeros((Gp, Tp), np.float32)
    cm[:G, :T] = _group_type_compat(js)
    fn = jrelax._floor_kernel(Gp, Tp, R, jrelax._relax_max_iters(),
                              jrelax._relax_tol(), jrelax._relax_rho())
    return float(np.asarray(fn(d, n, alloc, cm)["lb"])), (d, n, alloc, cm)


@pytest.mark.parametrize("family", FAMILIES)
def test_lp_bin_floor_matches_jax(family, monkeypatch):
    monkeypatch.setenv("KARPENTER_RELAX", "1")
    js, ts = snapshots(family)
    want_lb, want_in = jax_lb(js)
    for a, b in zip(want_in, trelax.floor_inputs(ts)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got = trelax.lp_bin_floor(ts, 0, "cpu")
    assert got == jrelax.lp_bin_floor(js, 0)
    assert got == int(np.ceil(want_lb - 1e-6))
    lb = trelax.RELAX_STATS["last_lb"]
    assert abs(lb - want_lb) <= LB_RTOL * max(abs(want_lb), 1.0)
    assert got > 0


def test_floor_gate_follows_device(monkeypatch):
    """Unset, the floor is on for a CUDA solver and off on the CPU, as the
    JAX package's is on an accelerator backend and off on the CPU; the
    knob overrides both ways."""
    monkeypatch.delenv("KARPENTER_RELAX", raising=False)
    assert trelax.relax_enabled(torch.device("cuda"))
    assert not trelax.relax_enabled(torch.device("cpu"))
    _, ts = snapshots("narrow")
    assert trelax.lp_bin_floor(ts, 3, "cpu") == 3
    monkeypatch.setenv("KARPENTER_RELAX", "0")
    assert not trelax.relax_enabled(torch.device("cuda"))
    monkeypatch.setenv("KARPENTER_RELAX", "1")
    assert trelax.relax_enabled(torch.device("cpu"))


def _claims(res):
    return [(c.template.nodepool_name, sorted(q.name for q in c.pods),
             sorted(it.name for it in c.instance_types))
            for c in res.new_claims]


@pytest.mark.parametrize("relax", ["1", "0"])
def test_plan_sizes_bins_as_tpu_solver(relax, monkeypatch):
    """With the floor on, the narrow family's bin axis comes from the LP:
    the port's ``plan`` gives TPUSolver's padded axis, and both solves
    open the same claims. With it off, both fall back to the demand bound
    (and grow the axis by doubling)."""
    monkeypatch.setenv("KARPENTER_RELAX", relax)
    seen = []
    real_invoke = TPUSolver._invoke

    def spy(self, args, key, max_bins):
        seen.append(max_bins)
        return real_invoke(self, args, key, max_bins)

    monkeypatch.setattr(TPUSolver, "_invoke", spy)
    jsolver, tsolver = TPUSolver(), TorchSolver(device="cpu")
    jres = jsolver.solve(*build("karpenter_tpu", "narrow"))
    tres = tsolver.solve(*build("karpenter_tpu_torch", "narrow"))
    _, ts = snapshots("narrow")
    p = tsolver.plan(ts)
    assert p["Bp"] == seen[0]
    assert p["lp_led"] == (relax == "1")
    if relax == "1":
        # the fault a port without the floor has on the card: a smaller
        # bin axis than the JAX package's (64 bins against 76)
        assert (p["floor"], p["B"], p["Bp"]) == (51, 76, 128)
        monkeypatch.setenv("KARPENTER_RELAX", "0")
        assert tsolver.plan(ts)["B"] == 64
    assert tsolver.last_device_stats["lp_led"] == (relax == "1")
    assert p["floor"] == tsolver.last_device_stats["floor"]
    assert (tsolver.last_device_stats.get("bin_growths", 0)
            == jsolver.last_device_stats.get("bin_growths", 0))
    assert _claims(tres) == _claims(jres)
    assert not tres.pod_errors and not jres.pod_errors


def test_floor_without_a_device_never_runs_on_the_cpu(monkeypatch):
    """``lp_bin_floor(snap, est)`` with no device means CUDA: on a machine
    without one it raises instead of running the PDHG on the CPU."""
    monkeypatch.setenv("KARPENTER_RELAX", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ts = snapshots("narrow")
    calls = trelax.RELAX_STATS["floor_calls"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trelax.lp_bin_floor(ts, 3)
    assert trelax.RELAX_STATS["floor_calls"] == calls


# ---------------------------------------------------------------------------
# the joint consolidation rung
# ---------------------------------------------------------------------------

JOINT_SEEDS = 60
FALLBACK_CAUSES = {"inexpressible", "iteration-cap", "non-convergence",
                   "price-gate", "lp-no-retirement"}


def mk_bundle(rng, G=4, E=12, N=8, fill_lo=0.15, fill_hi=0.65):
    """A seeded delete-only fleet (the shape of tests/test_relax.py's
    ``_mk_bundle``): E uniform nodes partially packed with pods of G sized
    groups, the N least-loaded nodes as retirement candidates in
    disruption-cost order, claims fenced off."""
    cap = np.tile(np.array([16.0, 64.0]), (E, 1))
    demand = np.stack(
        [rng.uniform(1.0, 5.0, G), rng.uniform(2.0, 12.0, G)], axis=1)
    counts = np.zeros((E, G), np.int64)
    for e in range(E):
        budget = cap[e] * rng.uniform(fill_lo, fill_hi)
        for _ in range(12):
            g = int(rng.integers(G))
            if np.all(demand[g] <= budget):
                counts[e, g] += 1
                budget = budget - demand[g]
    e_avail = cap - counts @ demand
    nodes = [SimpleNamespace(state_node=SimpleNamespace(provider_id=f"n{e}"))
             for e in range(E)]
    snap = SimpleNamespace(
        G=G, T=1, resources=("cpu", "mem"), g_demand=demand,
        t_alloc=np.array([[16.0, 64.0]]),
        m_overhead=np.array([[0.0, 0.0]]),
        t_tmpl=np.zeros(1, np.intp))
    esnap = SimpleNamespace(
        E=E, e_avail=e_avail, live=np.ones(E, bool),
        ge_ok=np.ones((G, E), bool), nodes=nodes)
    order = np.argsort(counts.sum(1), kind="stable")
    col_arr = order[:N].astype(np.int64)
    contrib = counts[col_arr].astype(np.float64)
    cum = np.cumsum(contrib, axis=0)
    bundle = SimpleNamespace(
        snap=snap, esnap=esnap, base=np.zeros(G, np.int64),
        claimable_groups=lambda: np.zeros(G, bool),
        generation=1, max_minv=0,
        type_price_vectors=lambda: (np.zeros(0, np.float64), {}))
    candidates = [
        SimpleNamespace(price=1.0, instance_type=SimpleNamespace(name="xl"))
        for _ in range(N)]
    return bundle, candidates, col_arr, contrib, cum


def decision(plan, cause, stats):
    if plan is None:
        return ("fallback", cause, stats["last_fallback"])
    return ("ship", list(plan.selected_idx), plan.displacement,
            plan.overflow, plan.n_claims, plan.solver, plan.k_device)


def run_joint(bundle, cands, col_arr, contrib, cum):
    """Both packages' joint_relax_plan on one bundle: their decisions and
    ``last_k_ub``."""
    jp, jc = jrelax.joint_relax_plan(bundle, cands, col_arr, contrib, cum, {})
    tp, tc = trelax.joint_relax_plan(bundle, cands, col_arr, contrib, cum,
                                     {}, device="cpu")
    return ((decision(jp, jc, jrelax.RELAX_STATS),
             jrelax.RELAX_STATS["last_k_ub"]),
            (decision(tp, tc, trelax.RELAX_STATS),
             trelax.RELAX_STATS["last_k_ub"]))


def jax_lp(bundle, col_arr, contrib):
    """The JAX joint kernel's LP on the bundle (joint_relax_plan keeps it
    internal): ``(y, k_frac, converged)``."""
    G = bundle.snap.G
    base_req = np.zeros(G)
    tensors, (Gp, Ec, Np, R) = jrelax._joint_tensors(
        bundle, col_arr, contrib, base_req, np.zeros(G, bool))
    fn, _ = jrelax._get_joint_kernel(Gp, Ec, Np, R)
    out = fn(*(tensors[k] for k in trelax.JOINT_TENSORS))
    return (np.asarray(out["y"]), float(out["k_frac"]),
            bool(out["converged"]), tensors)


@pytest.fixture
def no_capsule(monkeypatch):
    monkeypatch.setenv("KARPENTER_CAPSULE", "0")


def test_joint_relax_plan_matches_jax(no_capsule):
    ships = 0
    for seed in range(JOINT_SEEDS):
        bundle, cands, col_arr, contrib, cum = mk_bundle(
            np.random.default_rng(seed))
        want, got = run_joint(bundle, cands, col_arr, contrib, cum)
        assert got == want, seed
        ships += want[0][0] == "ship"
        # the continuous LP: the same tensors, y within 1e-4 relative
        y, k_frac, converged, tensors = jax_lp(bundle, col_arr, contrib)
        ttensors, _ = trelax._joint_tensors(
            bundle, col_arr, contrib, np.zeros(bundle.snap.G),
            np.zeros(bundle.snap.G, bool))
        for k in trelax.JOINT_TENSORS:
            assert np.array_equal(tensors[k], ttensors[k]), (seed, k)
        out = trelax.joint_lp(
            {k: torch.from_numpy(v) for k, v in ttensors.items()},
            trelax._relax_max_iters(), trelax._relax_tol(),
            trelax._relax_rho())
        assert out["converged"] == converged, seed
        assert abs(out["k_frac"] - k_frac) <= LB_RTOL * max(abs(k_frac), 1.0)
        assert np.allclose(out["y"].numpy(), y, rtol=LB_RTOL, atol=LB_RTOL)
    assert ships >= JOINT_SEEDS // 2, ships


@pytest.mark.parametrize("capture", ["0", "1"])
def test_joint_lp_reads_y_back_only_for_a_capture(capture, monkeypatch):
    """The LP's ``y`` joins the end-of-solve host read only when a replay
    capture will keep it (its ``rx_y`` sidecar); otherwise ``viol`` and
    ``sum(y)`` alone come back, and the plan is the same either way."""
    real_lp, seen = trelax.joint_lp, []

    def spy(*a, **kw):
        out = real_lp(*a, **kw)
        seen.append((kw.get("with_y", False), out))
        return out

    monkeypatch.setattr(trelax, "joint_lp", spy)
    # the capture itself (the bundle here has no shared snapshot) is
    # test_torch_capsule.py's
    monkeypatch.setattr(trelax, "_capture_joint", lambda *a, **kw: None)
    bundle, cands, col_arr, contrib, cum = mk_bundle(
        np.random.default_rng(0))
    monkeypatch.setenv("KARPENTER_CAPSULE", "0")
    jp, jc = jrelax.joint_relax_plan(bundle, cands, col_arr, contrib, cum, {})
    monkeypatch.setenv("KARPENTER_CAPSULE", capture)
    tp, tc = trelax.joint_relax_plan(bundle, cands, col_arr, contrib, cum,
                                     {}, device="cpu")
    assert (decision(tp, tc, trelax.RELAX_STATS)
            == decision(jp, jc, jrelax.RELAX_STATS))
    (with_y, out), = seen
    assert with_y is (capture == "1")
    if with_y:
        assert np.array_equal(out["y_host"], out["y"].numpy())
    else:
        assert out["y_host"] is None


def test_round_window_matches_jax():
    """The rounding window alone on windows past the LP bound: the same
    unplaced totals and claim usage (integer-valued floats, exactly)."""
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        bundle, _, col_arr, contrib, _ = mk_bundle(rng)
        G, E = bundle.snap.G, bundle.esnap.E
        claim = np.ones(G, bool)
        t, (Gp, Ec, Np, R) = trelax._joint_tensors(
            bundle, col_arr, contrib, np.zeros(G), claim)
        W = trelax.ROUND_WINDOW
        req_w = np.zeros((W, Gp), np.float32)
        surv = np.ones((W, Ec), np.float32)
        for i in range(W):
            k = len(col_arr) - i
            req_w[i, :G] = contrib[:k].sum(0)
            surv[i, col_arr[:k]] = 0.0
        surv_w = surv[:, :, None] * t["capR"][None]
        order = rng.permutation(Gp)
        want = jrelax._round_kernel(Gp, Ec, R, W, E)(
            req_w, surv_w, t["d"][order], t["compat"][order])
        got = trelax.round_window(
            torch.from_numpy(req_w), torch.from_numpy(surv_w),
            torch.from_numpy(t["d"][order]),
            torch.from_numpy(t["compat"][order]), E)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy()), seed


def test_joint_fallback_inexpressible(no_capsule):
    bundle = SimpleNamespace(
        base=np.ones(1, np.int64), snap=SimpleNamespace(G=1),
        claimable_groups=lambda: None)
    plan, cause = trelax.joint_relax_plan(
        bundle, [object(), object()], None, None, None, {}, device="cpu")
    assert plan is None and cause == "inexpressible"
    assert trelax.RELAX_STATS["last_fallback"] == "inexpressible"


def test_joint_fallback_iteration_cap(no_capsule, monkeypatch):
    monkeypatch.setenv("KARPENTER_RELAX_MAX_ITERS", "16")
    monkeypatch.setenv("KARPENTER_RELAX_TOL", "1e-12")
    want, got = run_joint(*mk_bundle(np.random.default_rng(0)))
    assert got == want
    assert got[0] == ("fallback", "iteration-cap", "iteration-cap")
    assert trelax.RELAX_STATS["last_iters"] == 16


def test_joint_fallback_lp_no_retirement(no_capsule):
    bundle, cands, col_arr, contrib, cum = mk_bundle(
        np.random.default_rng(1))
    bundle.esnap.e_avail = np.zeros_like(bundle.esnap.e_avail)
    bundle.snap.T = 0
    want, got = run_joint(bundle, cands, col_arr, contrib, cum)
    assert got == want
    assert got[0] == ("fallback", "lp-no-retirement", "lp-no-retirement")
    assert got[1] < 2


def test_joint_fallback_price_gate(no_capsule):
    G, E, N = 1, 4, 2
    e_avail = np.zeros((E, 2))
    e_avail[0] = e_avail[1] = [8.0, 32.0]  # candidates: 2 pods free
    nodes = [SimpleNamespace(state_node=SimpleNamespace(provider_id=f"n{e}"))
             for e in range(E)]
    snap = SimpleNamespace(
        G=G, T=1, resources=("cpu", "mem"), g_demand=np.array([[4.0, 16.0]]),
        t_alloc=np.array([[16.0, 64.0]]), m_overhead=np.array([[0.0, 0.0]]),
        t_tmpl=np.zeros(1, np.intp))
    esnap = SimpleNamespace(
        E=E, e_avail=e_avail, live=np.ones(E, bool),
        ge_ok=np.ones((G, E), bool), nodes=nodes)
    contrib = np.array([[2.0], [2.0]])
    bundle = SimpleNamespace(
        snap=snap, esnap=esnap, base=np.zeros(G, np.int64),
        claimable_groups=lambda: np.ones(G, bool), generation=1, max_minv=0,
        type_price_vectors=lambda: (np.array([1.0]), {"xl": 0}))
    cands = [SimpleNamespace(price=0.0, instance_type=SimpleNamespace(name="xl"))
             for _ in range(N)]
    want, got = run_joint(bundle, cands, np.array([0, 1], np.int64), contrib,
                          np.cumsum(contrib, 0))
    assert got == want
    assert got[0] == ("fallback", "price-gate", "price-gate")


def test_joint_fallback_non_convergence(no_capsule, monkeypatch):
    monkeypatch.setattr(jcons, "_greedy_displace", lambda *a, **k: None)
    monkeypatch.setattr(tcons, "_greedy_displace", lambda *a, **k: None)
    want, got = run_joint(*mk_bundle(np.random.default_rng(2)))
    assert got == want
    assert got[0] == ("fallback", "non-convergence", "non-convergence")


def test_joint_relax_plan_without_a_device_never_runs_on_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle, cands, col_arr, contrib, cum = mk_bundle(np.random.default_rng(4))
    attempts = trelax.RELAX_STATS["attempts"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trelax.joint_relax_plan(bundle, cands, col_arr, contrib, cum, {})
    assert trelax.RELAX_STATS["attempts"] == attempts
