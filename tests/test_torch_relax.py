"""The port's LP bin floor against the JAX package's.

Each family builds the same pods and catalog with each package's own
objects from a seed, tensorizes them on each side and runs
``lp_bin_floor`` with ``KARPENTER_RELAX=1`` (the knob the JAX package's
own tests use to turn the floor on off an accelerator). Tolerance: the
integer floor exact; the fractional bound ``lb`` within 1e-4 relative
(an fp32 PDHG of up to 384 iterations, XLA's CPU reductions against
torch's). The ``narrow`` family is one where the floor raises the
demand estimate, so the solver's bin axis depends on it: there the port's
``plan`` must size the axis exactly as ``TPUSolver`` does.
"""

import importlib
import random

import numpy as np
import pytest
import torch

from karpenter_tpu.models.solver import TPUSolver
from karpenter_tpu.ops import relax as jrelax
from karpenter_tpu.ops.tensorize import tensorize as jax_tensorize
from karpenter_tpu_torch.models import TorchSolver
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
