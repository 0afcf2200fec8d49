"""The port's consolidation probe against the JAX package's, bit for bit.

``dispatch_counterfactual_rows`` — the chunked probe dispatch every
consolidation entry point runs — on the same counterfactual rows over the
same shared snapshot: the JAX package's vmapped ``solve_step``
(``karpenter_tpu/ops/consolidate.py``) against the port's row-batched
``probe_step`` on the CPU.

Snapshots: seeded kernel-argument families of ``test_torch_kernels.py``
(existing nodes, topology classes, minValues, nodepool limits), and the
existing-node scenarios of ``test_torch_existing.py`` built by each
package's own ``tensorize``/``tensorize_existing``/``kernel_args`` — two of
them through a waves plan. Rows: prefix rows (candidates[:k+1] removed),
single rows (one candidate removed) and ``e_free`` release rows;
``max_bins`` 1 and 2; 130 rows in some cases, so two chunks and a padded
row axis. Tolerance: ``placed_g`` and ``used`` bit-equal.
"""

import importlib

import numpy as np
import pytest
import torch

from karpenter_tpu.ops import consolidate as jcons
from karpenter_tpu_torch.ops import consolidate as tcons
from karpenter_tpu_torch.ops import kernels as tkernels
from tests.test_torch_existing import scenario
from tests.test_torch_kernels import make_args


def counterfactual_rows(rng, G, E, rows, free_share=0.3, R=3):
    """``(g_count_k, e_zero_cols, e_free)``: prefix rows then single rows
    over a random candidate order of the E columns, each candidate
    contributing a few pods per group, pending pods in every row, and an
    ``e_free`` release on some rows."""
    order = rng.permutation(E)
    contrib = rng.integers(0, 3, size=(E, G)).astype(np.int32)
    base = rng.integers(0, 2, size=G).astype(np.int32)
    g_count, cols, free = [], [], []
    for i in range(rows):
        k = i % E
        if (i // E) % 2 == 0:  # prefix row: candidates[:k+1]
            g_count.append(base + contrib[order[:k + 1]].sum(0))
            cols.append(order[:k + 1])
        else:  # single row: candidate k alone
            g_count.append(base + contrib[order[k]])
            cols.append(order[k:k + 1])
        free.append(
            (int(rng.integers(0, E)), rng.uniform(0.0, 2.0, size=R))
            if rng.random() < free_share else None)
    return np.stack(g_count).astype(np.int32), cols, free


def run_both(shared_j, shared_t, Gp, Ep, e_avail, max_minv, rows, max_bins):
    g_count, cols, free = rows
    want = jcons.dispatch_counterfactual_rows(
        shared_j, Gp, Ep, e_avail, max_minv, g_count, cols, e_free=free,
        max_bins=max_bins)
    got = tcons.dispatch_counterfactual_rows(
        tkernels.from_kernel_args(shared_t, "cpu"), Gp, Ep, e_avail,
        max_minv, g_count, cols, e_free=free, max_bins=max_bins)
    return want, got


def assert_bit_equal(want, got):
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(g, w)


KERNEL_CASES = [("existing", 1, 130), ("mixed", 2, 130), ("minv", 1, 20),
                ("limits", 2, 20), ("classes", 1, 9)]


@pytest.mark.parametrize("family,max_bins,rows", KERNEL_CASES)
def test_probe_rows_bit_equal_on_kernel_families(family, max_bins, rows):
    args = make_args(family if family != "minv" else "mixed",
                     seed=500 + KERNEL_CASES.index((family, max_bins, rows)))
    if family in ("minv", "limits"):
        # the families without existing nodes take the mixed family's
        args.update({k: v for k, v in make_args("mixed", seed=7).items()
                     if k.startswith("e_") or k == "ge_ok"})
        if family == "limits":
            args["m_minv"][:] = 0
    shared = {k: v for k, v in args.items() if k not in ("g_count", "e_avail")}
    G, E = args["g_demand"].shape[0], args["e_avail"].shape[0]
    max_minv = int(args["m_minv"].max())
    assert (max_minv > 0) == (family in ("minv", "mixed"))
    rng = np.random.default_rng(rows + max_bins)
    cf = counterfactual_rows(rng, G, E, rows)
    want, got = run_both(shared, shared, G, E, args["e_avail"], max_minv,
                         cf, max_bins)
    assert_bit_equal(want, got)
    # the rows really exercised the pack: pods landed, bins opened
    assert got[0].sum() > 0 and got[1].sum() > 0


def snapshot(pkg: str, name: str):
    """(shared kernel args, Gp, Ep, e_avail, max_minv, G, E, plan?) of one
    existing-node scenario, built by the package's own functions on the
    probe's pure power-of-two ladder."""
    tz = importlib.import_module(f"{pkg}.ops.tensorize")
    waves = importlib.import_module(f"{pkg}.ops.waves")
    batch, templates, its, topology, enodes = scenario(pkg, name)
    plan = None
    if topology is not None and topology.has_groups:
        plan = waves.compile_topology(tz.group_by_signature(
            [p for p in batch if tz.device_basic_eligible(p)]), topology)
        snap = tz.tensorize(None, templates, its, device_plan=plan)
    else:
        snap = tz.tensorize(batch, templates, its)
    esnap = tz.tensorize_existing(snap, enodes, plan)
    Gp, Ep = jcons._pow2(snap.G), jcons._pow2(esnap.E)
    shared = tz.kernel_args(snap, esnap, Gp=Gp, Tp=jcons._pow2(snap.T),
                            Ep=Ep, include_counts=False)
    max_minv = int(snap.m_minv.max()) if snap.m_minv.size else 0
    return shared, Gp, Ep, esnap.e_avail, max_minv, snap.G, esnap.E, plan


SCENARIO_CASES = [("first_then_claims", 1, 130), ("random_mix", 2, 24),
                  ("spread_seeded", 1, 12), ("anti_declarer", 2, 12)]


@pytest.mark.parametrize("name,max_bins,rows", SCENARIO_CASES)
def test_probe_rows_bit_equal_on_snapshots(name, max_bins, rows):
    js = snapshot("karpenter_tpu", name)
    ts = snapshot("karpenter_tpu_torch", name)
    shared_j, Gp, Ep, e_avail, max_minv, G, E, plan = js
    shared_t = ts[0]
    assert ts[1:3] == (Gp, Ep) and np.array_equal(ts[3], e_avail)
    assert (plan is not None) == (name in ("spread_seeded", "anti_declarer"))
    assert sorted(shared_j) == sorted(shared_t)
    for k in shared_j:
        assert np.array_equal(shared_j[k], shared_t[k]), k
    rng = np.random.default_rng(len(name) + rows)
    # rows over G groups; columns over the E real nodes
    cf = counterfactual_rows(rng, G, E, rows, free_share=0.25,
                             R=e_avail.shape[1])
    want, got = run_both(shared_j, shared_t, Gp, Ep, e_avail, max_minv, cf,
                         max_bins)
    assert_bit_equal(want, got)
    assert got[0].sum() > 0


def test_probe_step_is_one_pack_for_all_rows(monkeypatch):
    """One chunk costs the compat launches of one solve whatever its row
    count: G×T and G×M once, then one ``[1, Np·B]`` product per group
    row — never a loop over rows."""
    calls = []
    real = tkernels.compat

    def counting(*args):
        calls.append((tuple(args[0].shape), tuple(args[3].shape)))
        return real(*args)

    monkeypatch.setattr(tkernels, "compat", counting)
    args = make_args("existing", seed=11)
    shared = {k: v for k, v in args.items() if k not in ("g_count", "e_avail")}
    G, E = args["g_demand"].shape[0], args["e_avail"].shape[0]
    rng = np.random.default_rng(1)
    for rows, Np in ((3, 4), (100, 128)):
        calls.clear()
        g_count, cols, free = counterfactual_rows(rng, G, E, rows)
        tcons.dispatch_counterfactual_rows(
            tkernels.from_kernel_args(shared, "cpu"), G, E, args["e_avail"],
            0, g_count, cols, e_free=free, max_bins=2)
        assert len(calls) == 2 + G
        assert calls[2:] == [((1, 3, 2), (Np * 2, 3, 2))] * G


def test_padded_rows_place_nothing():
    """Rows past the real ones (the pow-2 row padding) count zero pods,
    and a chunk's answer does not depend on its neighbours."""
    args = make_args("existing", seed=12)
    shared = tkernels.from_kernel_args(
        {k: v for k, v in args.items() if k not in ("g_count", "e_avail")},
        "cpu")
    G, E = args["g_demand"].shape[0], args["e_avail"].shape[0]
    g_count, cols, free = counterfactual_rows(np.random.default_rng(2), G,
                                              E, 5)
    e_master = torch.zeros((E, 3))
    e_master[:] = torch.from_numpy(args["e_avail"])
    varying = tcons.chunk_rows(e_master, g_count, cols, free, 0, 5, G)
    assert tuple(varying["g_count"].shape) == (8, G)
    assert int(varying["g_count"][5:].sum()) == 0
    placed, used = tkernels.probe_step(varying, shared, max_bins=2,
                                       max_minv=0)
    assert int(placed[5:].sum()) == 0 and int(used[5:].sum()) == 0
    alone = tcons.dispatch_counterfactual_rows(
        shared, G, E, args["e_avail"], 0, g_count[2:3], cols[2:3],
        e_free=free[2:3], max_bins=2)
    assert np.array_equal(alone[0][0], placed[2].numpy())
