"""The port's solve_step against the JAX package's, bit for bit.

Seeded numpy snapshots — one per tensor family ``solve_step`` covers —
are carried across with ``from_kernel_args`` and run through
``karpenter_tpu.ops.kernels.solve_step`` and
``karpenter_tpu_torch.ops.kernels.solve_step`` on the CPU. Tolerance:
exact for every output — the integer ones (assign, assign_e, used, npods,
types, tmpl, tier, F) and the f32 ``price``, which both sides compute as
the same minimum over the same f32 values.
"""

import numpy as np
import pytest

import torch

from karpenter_tpu.ops import kernels as jkernels
from karpenter_tpu_torch.ops import kernels as tkernels

GIB = float(2**30)
UNCAPPED = 1 << 30
FAMILIES = ["plain", "existing", "classes", "single", "minv", "limits",
            "tiers", "padded", "ties", "mixed"]


def _masks(rng, shape):
    """uint32 words with few low bits (so overlaps vary) and the sign bit
    set on some (so the int32 reinterpretation is exercised)."""
    m = rng.integers(0, 16, size=shape).astype(np.uint32)
    m[rng.random(shape) < 0.2] |= np.uint32(1 << 31)
    return m


def make_args(family: str, seed: int, G=8, T=16, K=3, W=2, M=2, O=3,
              E=5, C=2, CW=1, A=2):
    """A kernel_args-shaped numpy dict for one family (R = cpu, memory,
    pods). Every family keeps the defaults of the others."""
    rng = np.random.default_rng(seed)
    R = 3
    cpu = rng.choice([0.1, 0.25, 0.5, 1.0, 2.0, 3.7], size=G)
    mem = rng.uniform(0.1, 6.0, size=G) * GIB
    g_demand = np.stack([cpu, mem, np.ones(G)], axis=1).astype(np.float32)
    t_cpu = rng.choice([2.0, 4.0, 8.0, 16.0, 32.0], size=T)
    t_mem = t_cpu * rng.choice([2.0, 4.0, 8.0], size=T) * GIB * 0.93
    t_pods = rng.choice([20.0, 58.0, 110.0], size=T)
    t_alloc = np.stack([t_cpu * 0.95, t_mem, t_pods], axis=1).astype(np.float32)
    args = dict(
        g_mask=_masks(rng, (G, K, W)),
        g_has=rng.random((G, K)) < 0.4,
        g_tol=rng.random((G, K)) < 0.15,
        g_demand=g_demand,
        g_count=rng.integers(1, 60, size=G).astype(np.int32),
        g_zone_allowed=rng.random((G, 3)) < 0.8,
        g_ct_allowed=rng.random((G, 2)) < 0.8,
        g_tmpl_ok=rng.random((G, M)) < 0.9,
        t_mask=_masks(rng, (T, K, W)) | np.uint32(1),
        t_has=rng.random((T, K)) < 0.6,
        t_tol=rng.random((T, K)) < 0.15,
        t_alloc=t_alloc,
        t_cap=(t_alloc * np.float32(1.07)).astype(np.float32),
        t_tmpl=rng.integers(0, M, size=T).astype(np.int32),
        off_zone=rng.integers(-1, 3, size=(T, O)).astype(np.int32),
        off_ct=rng.integers(-1, 2, size=(T, O)).astype(np.int32),
        off_avail=rng.random((T, O)) < 0.85,
        off_price=rng.uniform(0.05, 3.0, size=(T, O)).astype(np.float32),
        m_mask=_masks(rng, (M, K, W)) | np.uint32(3),
        m_has=rng.random((M, K)) < 0.3,
        m_tol=np.zeros((M, K), dtype=bool),
        m_overhead=np.tile(np.array([0.1, 0.2 * GIB, 0.0], np.float32), (M, 1)),
        m_limits=np.full((M, R), np.inf, dtype=np.float32),
        m_minv=np.zeros(M, dtype=np.int32),
    )
    if family in ("existing", "classes", "mixed"):
        e_avail = np.stack([
            rng.uniform(0.0, 8.0, size=E), rng.uniform(0.0, 16.0, size=E) * GIB,
            rng.integers(0, 40, size=E).astype(np.float64)], axis=1)
        args.update(
            e_avail=e_avail.astype(np.float32),
            ge_ok=rng.random((G, E)) < 0.7,
            e_npods=rng.integers(0, 20, size=E).astype(np.int32),
            e_scnt=np.zeros((E, C), dtype=np.int32),
            e_decl=np.zeros((E, CW), dtype=np.uint32),
            e_match=np.zeros((E, CW), dtype=np.uint32),
            e_aff=np.zeros((E, A), dtype=np.int32),
        )
    if family in ("classes", "mixed"):
        # hostname anti-affinity conflict classes, spread caps, affinity
        args["g_decl"] = rng.integers(0, 4, size=(G, CW)).astype(np.uint32)
        args["g_match"] = rng.integers(0, 4, size=(G, CW)).astype(np.uint32)
        sown = np.full((G, C), UNCAPPED, dtype=np.int32)
        own = rng.random((G, C)) < 0.4
        sown[own] = rng.integers(1, 5, size=own.sum())
        args["g_sown"] = sown
        args["g_smatch"] = rng.random((G, C)) < 0.5
        args["g_aneed"] = rng.random((G, A)) < 0.25
        args["g_amatch"] = rng.random((G, A)) < 0.5
        args["g_bin_cap"] = np.where(rng.random(G) < 0.3,
                                     rng.integers(1, 4, size=G),
                                     UNCAPPED).astype(np.int32)
        args["e_scnt"] = rng.integers(0, 3, size=(E, C)).astype(np.int32)
        args["e_decl"] = rng.integers(0, 4, size=(E, CW)).astype(np.uint32)
        args["e_match"] = rng.integers(0, 4, size=(E, CW)).astype(np.uint32)
        args["e_aff"] = rng.integers(0, 2, size=(E, A)).astype(np.int32)
    if family in ("single", "mixed"):
        args["g_single"] = rng.random(G) < 0.4
        args["g_count"] = np.minimum(args["g_count"], 12).astype(np.int32)
    if family in ("minv", "mixed"):
        args["m_minv"] = rng.integers(0, 6, size=M).astype(np.int32)
        args["m_minv"][0] = 3
    if family in ("limits", "mixed"):
        lim = np.full((M, R), np.inf, dtype=np.float32)
        lim[:, 0] = rng.uniform(20.0, 80.0, size=M)
        lim[0, 1] = 120.0 * GIB
        args["m_limits"] = lim
    if family in ("tiers", "mixed"):
        tier = rng.integers(0, 3, size=G).astype(np.int32)
        order = np.argsort(-tier, kind="stable")  # rows arrive tier-major
        args = {k: (v[order] if k.startswith("g") or k == "ge_ok" else v)
                for k, v in args.items()}
        args["g_tier"] = tier[order]
    if family == "ties":
        # a capped first group opens equal bins; the single groups after it
        # see equal capacity on all of them, so the first maximum must win
        # (jnp.argmax and torch.argmax both take the first)
        args["g_demand"][:] = args["g_demand"][0]
        args["g_has"][:] = False
        args["g_tmpl_ok"][:] = True
        args["g_zone_allowed"][:] = True
        args["g_ct_allowed"][:] = True
        args["off_avail"][:] = True
        args["g_bin_cap"] = np.where(np.arange(G) == 0, 10, UNCAPPED).astype(np.int32)
        args["g_single"] = np.arange(G) > 0
        args["g_count"] = np.where(np.arange(G) == 0, 50, 3).astype(np.int32)
    if family in ("padded", "mixed"):
        # zero-demand padded rows (count 0, demand 0) and groups that leave
        # a resource undemanded: every ratio over d=0 becomes inf
        pad = rng.random(G) < 0.3
        pad[-1] = True
        args["g_count"] = np.where(pad, 0, args["g_count"]).astype(np.int32)
        args["g_demand"] = np.where(pad[:, None], 0.0,
                                    args["g_demand"]).astype(np.float32)
        args["g_demand"][0, 1] = 0.0
        args["g_mask"][pad] = 0
        args["g_has"][pad] = False
    return args


def run_both(args, max_bins, level_bits=20):
    max_minv = int(args["m_minv"].max())
    want = jkernels.solve_step(dict(args), max_bins=max_bins,
                               level_bits=level_bits, max_minv=max_minv,
                               use_pallas=False)
    got = tkernels.solve_step(tkernels.from_kernel_args(args, "cpu"),
                              max_bins=max_bins, level_bits=level_bits,
                              max_minv=max_minv)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_solve_step_bit_equal(family, seed):
    args = make_args(family, seed=1000 * FAMILIES.index(family) + seed)
    want, got = run_both(args, max_bins=24)
    assert set(got) >= {"assign", "assign_e", "used", "tmpl", "F", "price"}
    for key in want:
        w, g = want[key], got[key]
        assert g.shape == w.shape, key
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        assert g.dtype == w.dtype, (key, g.dtype, w.dtype)
        assert np.array_equal(g, w), key
    # the snapshot really exercised the pack: something landed
    assert got["assign"].sum() + got["assign_e"].sum() > 0
    if family == "ties":
        # single groups joined already-open bins
        assert (got["assign"][1:, :5] > 0).any()


@pytest.mark.parametrize("level_bits", [7, 8])
def test_short_level_search_bit_equal(level_bits):
    """The pods-capped search range the solver picks (level_bits ~8)."""
    args = make_args("mixed", seed=77 + level_bits)
    want, got = run_both(args, max_bins=16, level_bits=level_bits)
    for key in ("assign", "assign_e", "used", "tmpl", "F", "npods"):
        assert np.array_equal(got[key], want[key]), key


def test_bins_run_dry_bit_equal():
    """A bin axis too short for the demand: both sides leave the same
    remainder unplaced."""
    args = make_args("plain", seed=3)
    args["g_count"] = (args["g_count"] * 4).astype(np.int32)
    want, got = run_both(args, max_bins=4)
    assert got["used"].all()
    for key in ("assign", "used", "tmpl", "npods", "types"):
        assert np.array_equal(got[key], want[key]), key


def test_saturating_cast_matches_xla():
    """XLA's float→int32 saturates; torch's cast does not, so the port
    routes every floor→int32 through sat_int32."""
    import jax.numpy as jnp

    vals = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2147483520.0,
                     2147483648.0, -2147483648.0, 7.9, -7.9, 0.0],
                    dtype=np.float32)
    want = np.asarray(jnp.asarray(vals).astype(jnp.int32))
    got = tkernels.sat_int32(torch.from_numpy(vals)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert list(got[:4]) == [2**31 - 1, -(2**31), 0, 2**31 - 1]


def test_int32_cumsum_and_sum_stay_int32():
    """torch.cumsum/sum of int32 default to int64; the level fill's
    give-back rank and the bin rank pass dtype=int32."""
    x = torch.tensor([True, False, True, True])
    assert torch.cumsum(x.to(torch.int32), 0).dtype == torch.int64
    q = torch.tensor([3, 0, 2, 5], dtype=torch.int32)
    npods = torch.tensor([1, 0, 4, 0], dtype=torch.int32)
    take = tkernels._level_fill(q, npods, torch.tensor(6, dtype=torch.int32), 8)
    assert take.dtype == torch.int32
    assert int(take.sum()) == 6
    assert (take <= q).all()


def test_from_kernel_args_dtypes():
    args = make_args("classes", seed=9)
    t = tkernels.from_kernel_args(args, "cpu")
    assert t["g_mask"].dtype == torch.int32
    assert np.array_equal(t["g_mask"].numpy().view(np.uint32), args["g_mask"])
    assert t["g_has"].dtype == torch.bool
    assert t["g_demand"].dtype == torch.float32
    assert t["e_decl"].dtype == torch.int32
    assert all(tuple(t[k].shape) == args[k].shape for k in args)


def test_pack_routes_phase_b_through_compat(monkeypatch):
    """compat runs 2 + G times per solve_step: the G×T and G×M feasibility
    products, then one group row against the B bins per pack step."""
    calls = []
    real = tkernels.compat

    def counting(*args):
        calls.append((tuple(args[0].shape), tuple(args[3].shape)))
        return real(*args)

    monkeypatch.setattr(tkernels, "compat", counting)
    args = make_args("mixed", seed=5)
    G, T, K, W = 8, 16, 3, 2
    tkernels.solve_step(tkernels.from_kernel_args(args, "cpu"), max_bins=24)
    assert len(calls) == 2 + G
    assert calls[:2] == [((G, K, W), (T, K, W)), ((G, K, W), (2, K, W))]
    assert calls[2:] == [((1, K, W), (24, K, W))] * G
