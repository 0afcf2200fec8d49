"""The port's mesh (``karpenter_tpu_torch/parallel/mesh.py``) against the
JAX package's, rung by rung.

The JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``);
the port runs on logical CPU meshes of the same shapes (one device
repeated, ``logical_mesh``), so every shard and block of the port's
program runs at the shapes a real mesh of that shape gives it. Each case
of ``tests/test_partitioned_mesh.py`` and ``tests/test_mesh_sharding.py``
is here: the plan's bounds, budget and ``g_pad``; every partition blocker;
the kill-switch; padded group rows; the mesh against its oracle
(``partitioned_reference``) on 2 and 8 shards for seeds 3 and 11; the
single-device mesh; the merged host dict; the straddler repair; the
starved budget; the merged axis growing; the repair bound; the topology
and existing-node routes to the replicated rung; the DCN layout; and
``TorchSolver`` taking the mesh when ``_mesh``/``SHARD_MIN_WORK`` are set
as the JAX test sets them; and the decoder's multi-group exact-skip. The
multiply-add tie shape (400 pods of 200 cpu sizes over
``benchmark_catalog(64)``) goes through each rung.

Inputs: each package builds its own snapshot with its own tensorize from
the same pods (and the same numpy seed for the counts); the two argument
dicts are checked equal first.

Tolerance: exact — ``assign``, ``assign_e``, ``used``, ``tmpl``, ``F``,
the merged bin axis, ``LAST_RUN``'s engine, reason and ``repaired_pods``,
and the ``mesh.partition`` decisions.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from karpenter_tpu.obs import decisions as jdecisions
from karpenter_tpu.parallel import mesh as jmesh
from karpenter_tpu_torch.obs import decisions as pdecisions
from karpenter_tpu_torch.obs import devplane as pdevplane
from karpenter_tpu_torch.parallel import mesh as pmesh
from tests.test_torch_operator import JAX, PORT, mod

GIB = 2**30
OUT = ("assign", "assign_e", "used", "tmpl", "F")
MESH = {JAX: jmesh, PORT: pmesh}


# ---------------------------------------------------------------------------
# snapshots, built by each package from its own objects
# ---------------------------------------------------------------------------


def snapshot_args(snap) -> dict:
    """The solve arguments of a snapshot (``__graft_entry__``'s list)."""
    names = ("g_mask", "g_has", "g_tol", "g_demand", "g_count",
             "g_zone_allowed", "g_ct_allowed", "g_tmpl_ok", "g_bin_cap",
             "g_single", "g_decl", "g_match", "g_sown", "g_smatch", "t_mask",
             "t_has", "t_tol", "t_alloc", "t_cap", "t_tmpl", "off_zone",
             "off_ct", "off_avail", "off_price", "m_mask", "m_has", "m_tol",
             "m_overhead", "m_limits")
    return {k: getattr(snap, k) for k in names}


def _kit(pkg):
    ob = mod(pkg, "api.objects")
    pool = mod(pkg, "api.nodepool").NodePool(
        metadata=ob.ObjectMeta(name="default"))
    return (ob, pool, mod(pkg, "cloudprovider.catalog").benchmark_catalog,
            mod(pkg, "models").ClaimTemplate, mod(pkg, "ops.tensorize"))


def wide(pkg, n_groups=32, n_types=16, counts=None, seed=None):
    """``__graft_entry__._wide_snapshot``'s mix (one pod per distinct
    shape, 0.1..~5 cpu), counts from ``counts`` or a numpy seed."""
    ob, pool, catalog, CT, tz = _kit(pkg)
    pods = [ob.Pod(metadata=ob.ObjectMeta(name=f"w{i}"),
                   requests={"cpu": 0.1 + i * 0.01,
                             "memory": (0.25 + i * 0.01) * GIB})
            for i in range(n_groups)]
    snap = tz.tensorize(pods, [CT(pool)], {"default": catalog(n_types)})
    if counts is not None:
        snap.g_count = np.asarray(counts, dtype=np.int32)
    elif seed is not None:
        rng = np.random.RandomState(seed)
        snap.g_count = rng.randint(1, 60, size=snap.G).astype(np.int32)
    return snap, snapshot_args(snap)


def frag(pkg, n_groups=16, count=40):
    """One ~33-cpu pod per 64-cpu bin: the demand bound underestimates by
    ~2x, so budgets starve and straddlers are real."""
    ob, pool, catalog, CT, tz = _kit(pkg)
    pods = [ob.Pod(metadata=ob.ObjectMeta(name=f"p{i}"),
                   requests={"cpu": 33.0 + (i % n_groups) * 0.25,
                             "memory": 1.0 * GIB})
            for i in range(n_groups)]
    snap = tz.tensorize(pods, [CT(pool)], {"default": catalog(16)})
    snap.g_count = np.full(snap.G, count, dtype=np.int32)
    return snap, snapshot_args(snap)


def pinned(pkg, n=40):
    """One instance type pinned per group: both repair arms' cheap paths
    fail and the merged axis must grow."""
    ob, pool, catalog, CT, tz = _kit(pkg)
    wk = mod(pkg, "api.labels")
    names = [it.name for it in catalog(n)]
    pods = [ob.Pod(metadata=ob.ObjectMeta(name=f"p{i}"),
                   requests={"cpu": 0.1},
                   node_selector={wk.INSTANCE_TYPE_LABEL: names[i]})
            for i in range(n)]
    snap = tz.tensorize(pods, [CT(pool)], {"default": catalog(n)})
    return snap, snapshot_args(snap)


def example(pkg, n_pods=64, n_types=16, topology=False):
    """``__graft_entry__._example_snapshot``: four pod sizes; with
    ``topology`` a third zone-spread, a third hostname-spread and a third
    hostname anti-affinity, through the waves compiler."""
    ob, pool, catalog, CT, tz = _kit(pkg)
    wk = mod(pkg, "api.labels")
    sizes = [(0.25, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0)]

    def mk(i, **kw):
        labels = kw.pop("labels", {})
        return ob.Pod(metadata=ob.ObjectMeta(name=f"p{i}", labels=labels),
                      requests={"cpu": sizes[i % 4][0],
                                "memory": sizes[i % 4][1] * GIB}, **kw)

    if not topology:
        snap = tz.tensorize([mk(i) for i in range(n_pods)], [CT(pool)],
                            {"default": catalog(n_types)})
        return snap, snapshot_args(snap)

    def spread(key):
        return ob.TopologySpreadConstraint(
            max_skew=1, topology_key=key, when_unsatisfiable="DoNotSchedule",
            label_selector=ob.LabelSelector(match_labels={"app": "web"}))

    anti = ob.Affinity(pod_anti_affinity=ob.PodAffinity(required=[
        ob.PodAffinityTerm(topology_key=wk.HOSTNAME_LABEL,
                           label_selector=ob.LabelSelector(
                               match_labels={"app": "anti"}))]))
    third = n_pods // 3
    pods = [mk(i, labels={"app": "web"},
               topology_spread_constraints=[spread(wk.TOPOLOGY_ZONE_LABEL)])
            for i in range(third)]
    pods += [mk(third + i, labels={"app": "web"},
                topology_spread_constraints=[spread(wk.HOSTNAME_LABEL)])
             for i in range(third)]
    pods += [mk(2 * third + i, labels={"app": "anti"}, affinity=anti)
             for i in range(n_pods - 2 * third)]
    topo = mod(pkg, "models.topology").Topology(
        domains={wk.TOPOLOGY_ZONE_LABEL: {"zone-1", "zone-2", "zone-3"}},
        pods=pods)
    plan = mod(pkg, "ops.waves").compile_topology(
        tz.group_by_signature(pods), topo)
    assert not plan.host_pods
    snap = tz.tensorize(None, [CT(pool)], {"default": catalog(n_types)},
                        device_plan=plan)
    return snap, snapshot_args(snap)


def tie(pkg):
    """The multiply-add tie shape as the solver dispatches it: 400 pods of 200
    cpu sizes on one pool over ``benchmark_catalog(64)``, padded by
    ``kernel_args`` to Gp 256, Tp 64."""
    ob, pool, catalog, CT, tz = _kit(pkg)
    pods = [ob.Pod(metadata=ob.ObjectMeta(name=f"p{i}"),
                   requests={"cpu": 0.1 + (i % 200) * 0.01, "memory": GIB})
            for i in range(400)]
    snap = tz.tensorize(pods, [CT(pool)], {pool.name: catalog(64)})
    return snap, tz.kernel_args(snap)


def both(make, *a, **kw):
    """``make``'s (snap, args) for each package, the args checked equal
    array by array."""
    (js, ja), (ps, pa) = make(JAX, *a, **kw), make(PORT, *a, **kw)
    assert sorted(ja) == sorted(pa)
    for k in ja:
        np.testing.assert_array_equal(np.asarray(ja[k]), np.asarray(pa[k]),
                                      err_msg=k)
    return js, ja, pa


def copy(args):
    return {k: (np.array(v, copy=True) if isinstance(v, np.ndarray) else v)
            for k, v in args.items()}


# ---------------------------------------------------------------------------
# meshes: the JAX package's real virtual devices, the port's logical twin
# ---------------------------------------------------------------------------


def jax_mesh(n):
    return jmesh.make_mesh(n)


def port_mesh(jm):
    """A logical CPU mesh of the JAX mesh's shape."""
    return pmesh.logical_mesh(jm.devices.shape, "cpu")


def host(out) -> dict:
    """A rung's output as host numpy (the JAX package's lazy arrays or
    the port's tensors)."""
    if isinstance(out["used"], np.ndarray):
        return {k: out[k] for k in OUT}
    if isinstance(out["used"], torch.Tensor):
        return {k: out[k].numpy() for k in OUT}
    return {k: np.asarray(jax.device_get(out[k])) for k in OUT}


def last_run(pkg) -> tuple:
    lr = MESH[pkg].LAST_RUN
    return lr.get("engine"), lr.get("reason"), lr.get("repaired_pods")


def solve_both(jm, ja, pa, max_bins, level_bits=20):
    """``sharded_solve`` through both packages on their own args; checks
    the outputs, ``LAST_RUN`` and the decision equal; returns the port's
    host dict."""
    jdecisions.reset()
    pdecisions.reset()
    j = host(jmesh.sharded_solve(jm, ja, max_bins, level_bits=level_bits))
    jl = last_run(JAX)
    p = host(pmesh.sharded_solve(port_mesh(jm), pa, max_bins,
                                 level_bits=level_bits))
    assert last_run(PORT) == jl
    for k in OUT:
        assert j[k].shape == p[k].shape, k
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    jd = jdecisions.DECISIONS.site_summary().get("mesh.partition")
    pd = pdecisions.DECISIONS.site_summary().get("mesh.partition")
    assert pd == jd and pd is not None
    return p


def assert_bit_parity(out, ref):
    assert ref is not None
    for k in ("assign", "used", "tmpl", "F"):
        np.testing.assert_array_equal(np.asarray(out[k]), ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


class TestMesh:
    def test_make_mesh_counts_real_devices(self):
        m = pmesh.make_mesh(device="cpu")
        assert m.devices.shape == (1, 1)
        assert m.axis_names == ("data", "model")
        with pytest.raises(ValueError):
            pmesh.make_mesh(2, device="cpu")

    def test_no_device_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("checks the refusal on a machine without CUDA")
        _, args = wide(PORT, n_groups=16, seed=5)
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.partitioned_reference(args, 32, 2)

    def test_logical_mesh_repeats_one_device(self):
        m = pmesh.logical_mesh((2, 4), "cpu")
        assert m.shape == {"data": 2, "model": 4}
        assert {str(d) for d in m.devices.flat} == {"cpu"}

    def test_squarest_shape_matches_jax(self):
        for n in (1, 2, 4, 6, 8):
            assert pmesh._squarest(n) == jmesh.make_mesh(n).devices.shape

    def test_single_host_falls_back_to_flat(self):
        m = pmesh.make_multihost_mesh(n_hosts=1, device="cpu")
        assert set(m.axis_names) == {"data", "model"}
        # an over-asked topology degrades to the flat mesh, as in JAX
        assert pmesh.make_multihost_mesh(
            n_hosts=4, chips_per_host=2, device="cpu").devices.size == 1

    def test_shard_view_matches_jax(self):
        from karpenter_tpu.ops.tensorize import (
            GROUP_AXIS_KEYS as JKEYS, shard_view as jview)
        from karpenter_tpu_torch.ops.tensorize import (
            GROUP_AXIS_KEYS as PKEYS, shard_view as pview)

        assert PKEYS == JKEYS
        _, ja, pa = both(wide, n_groups=20, seed=13)
        for lo, hi, g_pad in ((0, 8, 8), (8, 20, 16), (3, 5, 8)):
            jv, pv = jview(ja, lo, hi, g_pad), pview(pa, lo, hi, g_pad)
            assert sorted(jv) == sorted(pv)
            for k in jv:
                np.testing.assert_array_equal(pv[k], jv[k], err_msg=k)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


class TestPlan:
    @pytest.mark.parametrize("n", [2, 8])
    def test_plan_covers_groups_contiguously(self, n):
        _, ja, pa = both(wide, n_groups=32, seed=1)
        jp, pp = jmesh.plan_shards(ja, n, 64), pmesh.plan_shards(pa, n, 64)
        assert pp is not None and pp.n_shards >= 2
        assert (pp.bounds, pp.g_pad, pp.budget, pp.need) == (
            jp.bounds, jp.g_pad, jp.budget, jp.need)
        lo = 0
        for blo, bhi in pp.bounds:
            assert blo == lo and bhi > blo
            lo = bhi
        assert lo == 32
        assert pp.budget >= 8 and pp.g_pad >= max(
            hi - lo for lo, hi in pp.bounds)
        assert pmesh.LAST_RUN.get("balance_ratio") == \
            jmesh.LAST_RUN.get("balance_ratio")
        assert pmesh.estimate_bin_axis(pa) == jmesh.estimate_bin_axis(ja)

    @pytest.mark.parametrize("mutate,reason", [
        (lambda a: a.update(e_avail=np.zeros((2, a["g_demand"].shape[1]),
                                             np.float32)), "existing-nodes"),
        (lambda a: a["m_limits"].__setitem__((0, 0), 100.0),
         "nodepool-limits"),
        (lambda a: a["g_single"].__setitem__(0, True), "single-bin-groups"),
        (lambda a: a["g_decl"].__setitem__((0, 0), 1), "topology-classes"),
        (lambda a: a["g_sown"].__setitem__((0, 0), 1), "topology-classes"),
        (lambda a: a.update(m_minv=np.array([2], np.int32)), "min-values"),
    ])
    def test_blockers_refuse_partition(self, mutate, reason):
        _, ja, pa = both(wide, n_groups=16)
        ja, pa = copy(ja), copy(pa)
        mutate(ja)
        mutate(pa)
        assert jmesh._partition_blockers(ja) == reason
        assert pmesh._partition_blockers(pa) == reason
        assert pmesh.plan_shards(pa, 8, 64) is None
        assert pmesh.LAST_RUN.get("plan_refusal") == reason

    def test_env_kill_switch(self, monkeypatch):
        _, ja, pa = both(wide, n_groups=16)
        monkeypatch.setenv("KARPENTER_SHARD_PARTITION", "0")
        assert pmesh.plan_shards(pa, 8, 64) is None
        assert pmesh.LAST_RUN.get("plan_refusal") == "partition-disabled"
        # the replicated rung runs, with the kill-switch as its reason
        out = solve_both(jax_mesh(8), ja, pa, 64)
        assert last_run(PORT)[:2] == ("replicated", "partition-disabled")
        assert out["F"].shape == (16, 16)

    def test_padded_group_rows_stay_eligible(self):
        """kernel_args pads the group axis with count-0 rows (20 -> 24):
        they block nothing and the mesh stays bit-equal to its oracle."""
        js, _, _ = both(wide, n_groups=20, n_types=16, seed=13)
        ps, _ = wide(PORT, n_groups=20, n_types=16, seed=13)
        ja = mod(JAX, "ops.tensorize").kernel_args(js)
        pa = mod(PORT, "ops.tensorize").kernel_args(ps)
        assert pa["g_count"].shape[0] > ps.G
        assert pmesh._partition_blockers(pa) is None
        assert pmesh.plan_shards(pa, 8, 64) is not None
        out = solve_both(jax_mesh(8), ja, pa, 64)
        assert last_run(PORT)[0] == "partitioned"
        assert_bit_parity(out, pmesh.partitioned_reference(
            pa, 64, 8, device="cpu"))
        pa2 = copy(pa)
        pa2["g_sown"][0, 0] = 1
        assert pmesh._partition_blockers(pa2) == "topology-classes"


# ---------------------------------------------------------------------------
# the partitioned rung
# ---------------------------------------------------------------------------


class TestPartitioned:
    @pytest.mark.parametrize("n_devices", [2, 8])
    @pytest.mark.parametrize("seed", [3, 11])
    def test_device_matches_oracle(self, n_devices, seed):
        snap, ja, pa = both(wide, n_groups=32, n_types=16, seed=seed)
        out = solve_both(jax_mesh(n_devices), ja, pa, 64)
        assert last_run(PORT)[0] == "partitioned"
        ref = pmesh.partitioned_reference(pa, 64, n_devices, device="cpu")
        assert_bit_parity(out, ref)
        jref = jmesh.partitioned_reference(ja, 64, n_devices)
        assert_bit_parity(out, {k: np.asarray(v) for k, v in jref.items()})
        assert int(out["assign"].sum()) == int(snap.g_count.sum())

    def test_single_shard_is_plain_unsharded(self):
        from jax.sharding import Mesh

        from karpenter_tpu_torch.ops import kernels

        _, ja, pa = both(wide, n_groups=16, seed=5)
        jm = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
        out = solve_both(jm, ja, pa, 32)
        assert last_run(PORT)[:2] == ("unsharded", "degenerate-mesh")
        ref = kernels.solve_step(kernels.from_kernel_args(pa, "cpu"),
                                 max_bins=32)
        np.testing.assert_array_equal(out["assign"], ref["assign"].numpy())
        np.testing.assert_array_equal(out["used"], ref["used"].numpy())

    def test_consumer_path_handles_merged_host_dict(self):
        snap, ja, pa = both(wide, n_groups=16, seed=7)
        j = jmesh.sharded_solve_host(jax_mesh(8), ja, 32)
        p = pmesh.sharded_solve_host(pmesh.logical_mesh((4, 2), "cpu"),
                                     pa, 32)
        assert set(p) >= set(OUT)
        assert p["assign"].shape[0] == snap.G
        for k in OUT:
            np.testing.assert_array_equal(p[k], np.asarray(j[k]), err_msg=k)

    def test_overlap_reads_zero_off_the_card(self):
        """Off the card a shard's work is done when its dispatch returns:
        the pipeline's overlap must read 0, never be invented."""
        _, _, pa = both(wide, n_groups=32, seed=9)
        ov0 = pdevplane.STATS["shard_overlap_ms"]
        pmesh.sharded_solve(pmesh.logical_mesh((4, 2), "cpu"), pa, 64)
        assert pmesh.LAST_RUN.get("engine") == "partitioned"
        assert pmesh.LAST_RUN.get("overlap_ms") == 0.0
        assert pdevplane.STATS["shard_overlap_ms"] == ov0
        assert len(pmesh.LAST_RUN.get("shards")) == \
            pmesh.LAST_RUN.get("n_shards")


class TestRepair:
    def test_straddlers_repair_into_other_shards(self):
        snap, ja, pa = both(wide, n_groups=8, n_types=16,
                            counts=[5, 5, 5, 5, 200, 200, 200, 200])
        plan = pmesh.ShardPlan(bounds=[(0, 4), (4, 8)], g_pad=8, budget=4,
                               need=[4, 4])
        jplan = jmesh.ShardPlan(bounds=[(0, 4), (4, 8)], g_pad=8, budget=4,
                                need=[4, 4])
        outs = pmesh._solve_shards(pa, plan, 20, device="cpu")
        merged = pmesh._merge_shards(pmesh._gather_shards(outs), plan,
                                     snap.G, snap.T)
        jouts = jmesh._solve_shards(ja, jplan, 20, devices=None)
        jmerged = jmesh._merge_shards(
            [jax.device_get({k: o[k] for k in pmesh._SHARD_KEYS})
             for o in jouts], jplan, snap.G, snap.T)
        for k in merged:
            np.testing.assert_array_equal(merged[k], jmerged[k], err_msg=k)
        total = int(snap.g_count.sum())
        assert int(merged["assign"].sum()) < total
        merged, repaired = pmesh._repair_merged(pa, merged, plan)
        jmerged, jrepaired = jmesh._repair_merged(ja, jmerged, jplan)
        assert repaired == jrepaired > 0
        for k in merged:
            np.testing.assert_array_equal(merged[k], jmerged[k], err_msg=k)
        assert int(merged["assign"].sum()) == total
        assert (merged["assign"].sum(axis=1)
                <= np.asarray(snap.g_count)).all()

    def test_starved_budget_keeps_oracle_parity(self):
        _, ja, pa = both(frag, n_groups=16, count=40)
        out = solve_both(jax_mesh(8), ja, pa, 64)
        assert last_run(PORT)[0] == "partitioned"
        assert_bit_parity(out, pmesh.partitioned_reference(
            pa, 64, 8, device="cpu"))

    def test_repair_grows_merged_axis_for_pinned_groups(self):
        snap, ja, pa = both(pinned)
        out = solve_both(jax_mesh(2), ja, pa, 16)
        assert last_run(PORT)[0] == "partitioned"
        assert last_run(PORT)[2] > 0
        assert int(out["assign"].sum()) == snap.G
        assert out["assign"].shape[1] > 16
        assert_bit_parity(out, pmesh.partitioned_reference(
            pa, 16, 2, device="cpu"))

    def test_repair_bound_falls_back_to_unsharded(self, monkeypatch):
        from karpenter_tpu_torch.ops import kernels

        _, ja, pa = both(frag, n_groups=16, count=40)
        monkeypatch.setenv("KARPENTER_SHARD_REPAIR_MAX", "1")
        fb0 = pdevplane.STATS["shard_fallbacks"]
        out = solve_both(jax_mesh(8), ja, pa, 64)
        assert last_run(PORT)[:2] == ("unsharded", "repair-bound")
        assert pdevplane.STATS["shard_fallbacks"] == fb0 + 1
        ref = kernels.solve_step(kernels.from_kernel_args(pa, "cpu"),
                                 max_bins=64)
        np.testing.assert_array_equal(out["assign"], ref["assign"].numpy())


# ---------------------------------------------------------------------------
# the replicated rung
# ---------------------------------------------------------------------------


def with_existing(args, G, n=2, avail=1e12):
    R = args["g_demand"].shape[1]
    return dict(args, e_avail=np.full((n, R), avail, np.float32),
                ge_ok=np.ones((G, n), bool), e_npods=np.zeros(n, np.int32))


class TestReplicated:
    def test_topology_classes_route_replicated(self):
        from karpenter_tpu_torch.ops import kernels

        snap, ja, pa = both(example, n_pods=45, n_types=16, topology=True)
        out = solve_both(jax_mesh(8), ja, pa, 48)
        assert last_run(PORT)[:2] == ("replicated", "topology-classes")
        ref = kernels.solve_step(kernels.from_kernel_args(pa, "cpu"),
                                 max_bins=48)
        np.testing.assert_array_equal(out["assign"][:snap.G],
                                      ref["assign"].numpy())

    def test_exact_parity_with_unsharded(self):
        from karpenter_tpu_torch.ops import kernels

        snap, ja, pa = both(example, n_pods=90, n_types=32, topology=True)
        out = solve_both(jax_mesh(8), ja, pa, 96)
        ref = kernels.solve_step(kernels.from_kernel_args(pa, "cpu"),
                                 max_bins=96)
        np.testing.assert_array_equal(out["assign"][:snap.G],
                                      ref["assign"].numpy())
        assert int(out["used"].sum()) == int(ref["used"].sum())

    def test_sharded_carries_existing_nodes(self):
        from karpenter_tpu_torch.ops import kernels

        snap, ja, pa = both(example, n_pods=32, n_types=16)
        G = pa["g_count"].shape[0]
        ja, pa = with_existing(ja, G), with_existing(pa, G)
        out = solve_both(jax_mesh(8), ja, pa, 32)
        assert last_run(PORT)[:2] == ("replicated", "existing-nodes")
        ref = kernels.solve_step(kernels.from_kernel_args(pa, "cpu"),
                                 max_bins=32)
        np.testing.assert_array_equal(out["assign_e"][:G],
                                      ref["assign_e"].numpy())
        assert int(out["assign_e"].sum()) > 0

    def test_existing_nodes_route_replicated(self):
        snap, ja, pa = both(example, n_pods=16, n_types=8)
        G = pa["g_count"].shape[0]
        solve_both(jax_mesh(8), with_existing(ja, G), with_existing(pa, G),
                   16)
        assert last_run(PORT)[:2] == ("replicated", "existing-nodes")

    def test_dcn_layout_parity(self):
        """Hosts on the data axis, one host's devices on the model axis
        (2 × 4): the JAX package's multi-host mesh against a logical one
        of the same shape; T pads to the model multiple."""
        from karpenter_tpu_torch.ops import kernels

        jm = jmesh.make_multihost_mesh(n_hosts=2, chips_per_host=4)
        assert dict(zip(jm.axis_names, jm.devices.shape)) == {
            "data": 2, "model": 4}
        snap, ja, pa = both(example, n_pods=90, n_types=30, topology=True)
        out = solve_both(jm, ja, pa, 96)
        assert out["F"].shape[1] % 4 == 0
        ref = kernels.solve_step(kernels.from_kernel_args(pa, "cpu"),
                                 max_bins=96)
        np.testing.assert_array_equal(out["assign"][:snap.G],
                                      ref["assign"].numpy())

    @pytest.mark.parametrize("shape,max_bins", [((4, 2), 8), ((4, 2), 16),
                                                ((2, 4), 8), ((2, 4), 32)])
    def test_capacity_rule_at_the_shard_shape(self, shape, max_bins):
        """The replicated program contracts the capacity formula when the
        bin axis equals the per-device type shard (Tp / n_model): bins at
        and off that size, on both mesh layouts, against JAX."""
        snap, ja, pa = both(wide, n_groups=64, n_types=31, seed=3)
        ja, pa = copy(ja), copy(pa)
        ja["m_limits"][:] = 1e9
        pa["m_limits"][:] = 1e9
        jm = (jmesh.make_mesh(8) if shape == (4, 2)
              else jmesh.make_multihost_mesh(2, 4))
        solve_both(jm, ja, pa, max_bins)
        assert last_run(PORT)[:2] == ("replicated", "nodepool-limits")


# ---------------------------------------------------------------------------
# the multiply-add tie shape through each rung
# ---------------------------------------------------------------------------


class TestTieShape:
    @pytest.mark.parametrize("n", [2, 8])
    def test_partitioned(self, n):
        _, ja, pa = both(tie)
        out = solve_both(jax_mesh(n), ja, pa, 64)
        assert last_run(PORT)[0] == "partitioned"
        assert_bit_parity(out, pmesh.partitioned_reference(
            pa, 64, n, device="cpu"))

    @pytest.mark.parametrize("max_bins", [64, 32])
    def test_replicated(self, monkeypatch, max_bins):
        monkeypatch.setenv("KARPENTER_SHARD_PARTITION", "0")
        _, ja, pa = both(tie)
        solve_both(jax_mesh(8), ja, pa, max_bins)
        assert last_run(PORT)[:2] == ("replicated", "partition-disabled")

    def test_unsharded(self):
        from jax.sharding import Mesh

        _, ja, pa = both(tie)
        jm = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
        out = solve_both(jm, ja, pa, 64)
        assert last_run(PORT)[0] == "unsharded"
        # both 0.83-cpu pods of row 126 land on bin 5, none on bin 1
        assert out["assign"][126, 1] == 0 and out["assign"][126, 5] == 2


# ---------------------------------------------------------------------------
# the solver's mesh route and the planes
# ---------------------------------------------------------------------------


class TestSolverRoute:
    def test_cpu_solver_has_no_mesh(self):
        from karpenter_tpu_torch.models import TorchSolver

        assert TorchSolver(device="cpu")._maybe_mesh() is None

    def test_torchsolver_takes_the_mesh(self, monkeypatch):
        """Above SHARD_MIN_WORK (set to 1, as the JAX test sets it) with a
        mesh installed, the solve routes through sharded_solve: the route
        and the claims equal the JAX package's, and one dispatch gives one
        ``mesh.solve`` capture and no ``solver.invoke`` one."""
        from karpenter_tpu import parallel as jparallel
        from karpenter_tpu.models import solver as jsolver
        from karpenter_tpu_torch import parallel as pparallel
        from karpenter_tpu_torch.models import solver as psolver
        from karpenter_tpu_torch.obs import capsule

        calls = {JAX: 0, PORT: 0}

        def spy(pkg, orig):
            def f(mesh, args, max_bins, level_bits=20):
                calls[pkg] += 1
                return orig(mesh, args, max_bins, level_bits=level_bits)
            return f

        monkeypatch.setattr(jparallel, "sharded_solve",
                            spy(JAX, jparallel.sharded_solve))
        monkeypatch.setattr(pparallel, "sharded_solve",
                            spy(PORT, pparallel.sharded_solve))
        monkeypatch.setattr(jsolver, "SHARD_MIN_WORK", 1)
        monkeypatch.setattr(psolver, "SHARD_MIN_WORK", 1)
        claims = {}
        for pkg in (JAX, PORT):
            ob, pool, catalog, CT, _ = _kit(pkg)
            pods = [ob.Pod(metadata=ob.ObjectMeta(name=f"p{i}"),
                           requests={"cpu": 0.5 + (i % 7) * 0.25,
                                     "memory": (1 + i % 5) * GIB})
                    for i in range(400)]
            if pkg == JAX:
                s = jsolver.TPUSolver()
            else:
                s = psolver.TorchSolver(device="cpu")
                s._mesh, s._mesh_checked = pmesh.logical_mesh((4, 2),
                                                              "cpu"), True
                capsule.reset()
            res = s.solve(pods, [CT(pool)], {"default": catalog(64)})
            assert res.scheduled_pod_count() + len(res.pod_errors) == 400
            claims[pkg] = [(c.template.nodepool_name,
                            sorted(p.metadata.name for p in c.pods),
                            sorted(it.name for it in c.instance_types))
                           for c in res.new_claims]
        assert calls == {JAX: 1, PORT: 1}
        assert claims[PORT] == claims[JAX]
        assert s._route == ("mesh", "ok")
        assert s.last_device_stats["engine"] == "mesh"
        assert capsule.last_capture()["seam"] == "mesh.solve"

    def test_spans_and_planes_match_jax(self):
        """One partitioned solve opens the JAX package's shard spans and
        records the same pad-site cells and shard repair/balance stats."""
        from karpenter_tpu import obs as jobs
        from karpenter_tpu.obs import devplane as jdevplane
        from karpenter_tpu_torch import obs as pobs

        _, ja, pa = both(frag, n_groups=16, count=40)
        names, stats = {}, {}
        for pkg, o, dp, run in (
                (JAX, jobs, jdevplane,
                 lambda: jmesh.sharded_solve_host(jax_mesh(8), ja, 64)),
                (PORT, pobs, pdevplane,
                 lambda: pmesh.sharded_solve_host(
                     pmesh.logical_mesh((4, 2), "cpu"), pa, 64))):
            o.configure(enabled=True, capacity=8)
            dp.reset()
            try:
                with o.round_trace("mesh") as tr:
                    run()
                names[pkg] = sorted({s.name for s in tr.spans()})
                stats[pkg] = (dp.STATS["shard_repair_pods"],
                              dp.STATS["shard_balance_ratio"],
                              dp.STATS["pad_cells_actual"],
                              dp.STATS["pad_cells_padded"])
            finally:
                o.reset()
        assert names[PORT] == names[JAX]
        assert {"shard.tensorize", "shard.dispatch", "shard.block",
                "shard.merge", "shard.repair"} <= set(names[PORT])
        assert stats[PORT] == stats[JAX]
        assert stats[PORT][0] > 0


class TestDecodeExactSkip:
    """``tests/test_partitioned_mesh.py``'s decoder cases: the multi-group
    exact-skip (``_decomposable``) decides as the JAX package's, and a
    selector-heavy mix whose bins host several groups gives the same
    claims with the skip engaged."""

    def test_decomposable_conditions(self):
        from karpenter_tpu.models import TPUSolver
        from karpenter_tpu_torch.models import TorchSolver

        got = {}
        for pkg, dec in ((JAX, TPUSolver._decomposable),
                         (PORT, TorchSolver._decomposable)):
            ob, pool, catalog, CT, tz = _kit(pkg)
            wk = mod(pkg, "api.labels")

            def mk(name, sel, cpu):
                return ob.Pod(metadata=ob.ObjectMeta(name=name),
                              requests={"cpu": cpu, "memory": GIB},
                              node_selector=sel)

            pods = [mk("a", {wk.ARCH_LABEL: "amd64"}, 0.25),
                    mk("b", {wk.ARCH_LABEL: "amd64"}, 0.5),
                    mk("c", {wk.ARCH_LABEL: "arm64"}, 0.5),
                    mk("d", {}, 0.5),
                    mk("e", {wk.TOPOLOGY_ZONE_LABEL: "zone-1"}, 0.25),
                    mk("f", {wk.CAPACITY_TYPE_LABEL: "spot"}, 0.25)]
            snap = tz.tensorize(pods, [CT(pool)], {"default": catalog(8)})
            g = {grp[0].metadata.name: i for i, grp in enumerate(snap.groups)}
            got[pkg] = [dec(snap, [g[x], g[y]]) for x, y in (
                ("a", "b"), ("a", "d"), ("a", "c"), ("e", "d"), ("e", "f"))]
        assert got[PORT] == got[JAX] == [True, True, False, True, False]

    def test_skip_changes_no_claim(self):
        from karpenter_tpu.models import TPUSolver
        from karpenter_tpu_torch.models import TorchSolver

        claims, skips = {}, {}
        for pkg, solver in ((JAX, TPUSolver), (PORT, TorchSolver)):
            ob, pool, catalog, CT, tz = _kit(pkg)
            wk = mod(pkg, "api.labels")
            sizes = [(0.25, 0.5), (0.5, 1.0), (0.75, 1.5), (1.0, 2.0)]
            sels = [{}, {wk.ARCH_LABEL: "amd64"}, {wk.ARCH_LABEL: "arm64"}]
            pods = [ob.Pod(metadata=ob.ObjectMeta(name=f"p{i}"),
                           requests={"cpu": sizes[i % 4][0],
                                     "memory": sizes[i % 4][1] * GIB},
                           node_selector=dict(sels[i % 3]))
                    for i in range(96)]
            s0 = tz.STATS["decode_exact_skips"]
            s = solver() if pkg == JAX else solver(device="cpu")
            res = s.solve(pods, [CT(pool)], {"default": catalog(24)})
            skips[pkg] = tz.STATS["decode_exact_skips"] - s0
            assert res.scheduled_pod_count() == 96
            claims[pkg] = sorted(
                (c.template.nodepool_name,
                 sorted(it.name for it in c.instance_types),
                 sorted(p.metadata.name for p in c.pods))
                for c in res.new_claims)
        assert claims[PORT] == claims[JAX]
        assert skips[PORT] == skips[JAX] > 0
