"""The port's requirement-compat plain version against the JAX package.

``compat_reference`` (karpenter_tpu_torch/ops/cuda_kernels.py) is what the
port's CPU path runs and what chip_smoke.py holds the CUDA kernel against,
so it is pinned here to the JAX side on identical inputs: the Pallas kernel
in interpret mode for single-word masks (the shapes of
tests/test_pallas_kernels.py), and the jnp compat loop inside JAX
``feasibility`` for multi-word masks (W up to 16, the headline's width).
Tolerance: exact — the outputs are booleans.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from karpenter_tpu.ops import kernels as jkernels
from karpenter_tpu.ops.pallas_kernels import compat_pallas
from karpenter_tpu_torch.ops import cuda_kernels


def random_case(rng, G, T, K, W):
    """int32 bit patterns [G|T, K, W] (sign bit included), has/tol [., K]."""
    g_mask = rng.integers(-(2**31), 2**31 - 1, size=(G, K, W), dtype=np.int32)
    t_mask = rng.integers(-(2**31), 2**31 - 1, size=(T, K, W), dtype=np.int32)
    # sparse definedness so ~both dominates some keys
    g_has = rng.random((G, K)) < 0.6
    t_has = rng.random((T, K)) < 0.6
    # guaranteed-disjoint words so the overlap arm decides some cells
    g_mask[rng.random((G, K, W)) < 0.7] = 0b0101
    t_mask[rng.random((T, K, W)) < 0.7] = 0b1010
    g_tol = rng.random((G, K)) < 0.2
    t_tol = rng.random((T, K)) < 0.2
    return g_mask, g_has, g_tol, t_mask, t_has, t_tol


def port_compat(g_mask, g_has, g_tol, t_mask, t_has, t_tol):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (g_mask, g_has, g_tol, t_mask, t_has, t_tol)]
    return cuda_kernels.compat(*t).numpy()


@pytest.mark.parametrize("shape", [(3, 5, 4), (8, 128, 7), (21, 300, 11),
                                   (64, 1024, 3), (4, 9, 128)])
def test_single_word_matches_pallas(shape):
    G, T, K = shape
    rng = np.random.default_rng(G * 1000 + T)
    gm, gh, gt, tm, th, tt = random_case(rng, G, T, K, 1)
    want = np.asarray(compat_pallas(
        jnp.asarray(gm[:, :, 0]), jnp.asarray(gh), jnp.asarray(gt),
        jnp.asarray(tm[:, :, 0]), jnp.asarray(th), jnp.asarray(tt),
        interpret=True))
    got = port_compat(gm, gh, gt, tm, th, tt)
    assert got.shape == (G, T)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(5, 7, 3, 2), (32, 64, 9, 16),
                                   (9, 130, 4, 5), (1, 1, 1, 16)])
def test_multi_word_matches_jnp_loop(shape):
    """W>1 goes through JAX feasibility's jnp loop; with every resource
    fitting and every offering open, F is exactly compat over types and
    tmpl_full exactly compat over templates."""
    G, T, K, W = shape
    M = 3
    rng = np.random.default_rng(G * 7919 + T * 31 + W)
    gm, gh, gt, tm, th, tt = random_case(rng, G, T, K, W)
    _, _, _, mm, mh, mt = random_case(rng, 1, M, K, W)
    u32 = lambda a: jnp.asarray(a.view(np.uint32))  # noqa: E731
    F, _, tmpl_full = jkernels.feasibility(
        u32(gm), jnp.asarray(gh), jnp.zeros((G, 1), jnp.float32),
        u32(tm), jnp.asarray(th), jnp.ones((T, 1), jnp.float32),
        jnp.ones((G, 1), bool), jnp.ones((G, 1), bool),
        jnp.full((T, 1), -1, jnp.int32), jnp.full((T, 1), -1, jnp.int32),
        jnp.ones((T, 1), bool), jnp.ones((T, 1), jnp.float32),
        jnp.ones((G, M), bool), u32(mm), jnp.asarray(mh),
        g_tol=jnp.asarray(gt), t_tol=jnp.asarray(tt), m_tol=jnp.asarray(mt),
        use_pallas=False,
    )
    assert np.array_equal(port_compat(gm, gh, gt, tm, th, tt), np.asarray(F))
    assert np.array_equal(port_compat(gm, gh, gt, mm, mh, mt),
                          np.asarray(tmpl_full))


def test_tolerance_and_undefined_arms():
    """Disjoint masks are compatible only when both sides tolerate
    (NotIn/DoesNotExist) or either side leaves the key undefined."""
    one = lambda v: np.array([[[v]]], dtype=np.int32)  # noqa: E731
    b = lambda v: np.array([[v]])  # noqa: E731
    assert port_compat(one(1), b(True), b(True), one(2), b(True), b(True))[0, 0]
    assert not port_compat(one(1), b(True), b(True), one(2), b(True), b(False))[0, 0]
    assert port_compat(one(1), b(True), b(False), one(2), b(False), b(False))[0, 0]
    assert port_compat(one(3), b(True), b(False), one(2), b(True), b(False))[0, 0]


def test_cpu_tensors_take_the_plain_version():
    """The wrapper runs the plain version for CPU tensors and counts no
    kernel launch."""
    rng = np.random.default_rng(5)
    case = random_case(rng, 4, 6, 2, 3)
    before = cuda_kernels.LAUNCHES["compat"]
    got = port_compat(*case)
    want = cuda_kernels.compat_reference(
        *[torch.from_numpy(a) for a in case]).numpy()
    assert np.array_equal(got, want)
    assert cuda_kernels.LAUNCHES["compat"] == before


def _load_chip_smoke():
    """chip_smoke.py's module constants (it imports torch only inside its
    functions, so loading it here runs nothing on a card)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _load_chip_smoke()
# the headline's main-path products (G×T, G×M, pack's one row × Bp bins),
# then every other shape chip_smoke.py launches the kernel at
TILE_SHAPES = ([(32, 1024, 9, 16), (32, 2, 9, 16), (1, 1536, 9, 16),
                _SMOKE.SCALE_SHAPE] + list(_SMOKE.EDGE_SHAPES))


@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_tile_covers_every_pair_once(shape):
    """The kernel's grid, threads and per-thread register tile
    (csrc/compat.cu: with tl = tt // rt, thread ``tid`` of block (bx, by)
    tests types bx*tt + tid % tl + q*tl against group rows
    by*tg + (tid // tl)*rg + r) hit every (g, t) cell exactly once, within
    the card's shared memory and the kernel's 256-thread launch bound
    (threads beyond the testing ones only stage rows)."""
    G, T, K, W = shape
    tile = cuda_kernels.compat_tile(G, T, K, W)
    tl = tile.tt // tile.rt
    testing = tl * (tile.tg // tile.rg)
    assert testing <= tile.threads <= 256
    assert (tile.rg, tile.rt) in ((1, 1), (4, 4))
    assert tile.tg % tile.rg == 0 and tile.tt % tile.rt == 0
    assert 1 <= tile.kc <= K
    assert tile.smem == cuda_kernels._compat_smem(tile.tt, tile.tg, tile.kc, K, W)
    assert tile.smem <= 232448
    assert tile.grid == (-(-T // tile.tt), -(-G // tile.tg))
    bx, by, tid, r, q = np.meshgrid(
        np.arange(tile.grid[0]), np.arange(tile.grid[1]),
        np.arange(testing), np.arange(tile.rg), np.arange(tile.rt),
        indexing="ij")
    t = bx * tile.tt + tid % tl + q * tl
    g = by * tile.tg + (tid // tl) * tile.rg + r
    keep = (t < T) & (g < G)
    hits = np.zeros((G, T), dtype=np.int64)
    np.add.at(hits, (g[keep], t[keep]), 1)
    assert (hits == 1).all()


def test_tile_fills_the_card_at_the_headline():
    """At G×T 32×1024 the launch spreads over the 132 SMs with one pair per
    thread; at the scale shape each thread takes a 4 × 4 tile of pairs and
    the grid still covers every SM more than twice."""
    gt = cuda_kernels.compat_tile(32, 1024, 9, 16)
    assert (gt.rg, gt.rt) == (1, 1) and gt.grid[0] * gt.grid[1] >= 132
    scale = cuda_kernels.compat_tile(*_SMOKE.SCALE_SHAPE)
    assert (scale.rg, scale.rt) == (4, 4)
    assert scale.grid[0] * scale.grid[1] >= 2 * 132


def test_tile_refuses_a_key_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="shared-memory"):
        cuda_kernels.compat_tile(4, 64, 2, 60000)


def _bins(rng, B, K, W):
    """Bin rows as pack carries them: one to three allowed values per key,
    anywhere in its W words (the sign bit included), mixed definedness."""
    m = np.zeros((B, K, W), dtype=np.uint32)
    for _ in range(3):
        bit = rng.integers(0, 32 * W, size=(B, K))
        on = rng.random((B, K)) < 0.7
        b, k = np.nonzero(on)
        m[b, k, bit[on] // 32] |= (np.uint32(1) << (bit[on] % 32).astype(np.uint32))
    return m.view(np.int32), rng.random((B, K)) < 0.5


@pytest.mark.parametrize("W,B", [(1, 1536), (3, 700), (16, 1536), (16, 5)])
def test_phase_b_through_compat_equals_inline_formula(W, B):
    """Pack's phase B now calls compat(gm[None], gh[None], 0, bmask, bhas,
    0)[0]; it equals the inline formula it replaced (and JAX's
    kernels.py phase B) on random bins."""
    K = 9
    rng = np.random.default_rng(W * 10007 + B)
    for _ in range(4):
        bmask, bhas = _bins(rng, B, K, W)
        gm, gh = _bins(rng, 1, K, W)
        bm_t, bh_t = torch.from_numpy(bmask), torch.from_numpy(bhas)
        gm_t, gh_t = torch.from_numpy(gm[0]), torch.from_numpy(gh[0])
        both = bh_t & gh_t[None, :]
        ov = ((bm_t & gm_t[None, :, :]) != 0).any(-1)
        want = (~both | ov).all(-1)
        got = cuda_kernels.compat(gm_t[None], gh_t[None],
                                  torch.zeros((1, K), dtype=torch.bool), bm_t,
                                  bh_t, torch.zeros((B, K), dtype=torch.bool))
        assert got.shape == (1, B)
        assert torch.equal(got[0], want)
        if B > 100:
            assert not want.all() and want.any()  # both outcomes occur


@pytest.mark.parametrize("shape", [(1, 1536, 9, 16), (5, 7, 3, 2),
                                   (32, 64, 9, 16), (1, 1, 1, 1)])
def test_reference_matches_broadcast_formula(shape):
    """compat_reference's key-by-key loop gives the cells of the formula
    over the whole [G,T,K,W] product at once."""
    rng = np.random.default_rng(sum(shape))
    gm, gh, gt, tm, th, tt = [torch.from_numpy(a)
                              for a in random_case(rng, *shape)]
    ov = ((gm[:, None] & tm[None]) != 0).any(-1) | (gt[:, None] & tt[None])
    want = (~(gh[:, None] & th[None]) | ov).all(-1)
    got = cuda_kernels.compat_reference(gm, gh, gt, tm, th, tt)
    assert torch.equal(got, want)
