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
