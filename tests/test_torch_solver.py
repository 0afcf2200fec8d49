"""The port's tensorize and TorchSolver against the JAX package.

The headline workload scaled down (2,000 pods × 60 types, the same 24
deployment shapes and two NodePools) is built twice — from the JAX
package's objects by bench.py's ``build_workload`` and from the port's by
``karpenter_tpu_torch.workload`` — and compiled and solved by each side.
Tolerance: exact. Snapshot arrays and kernel-arg dicts must be equal;
solves must give the same claims in the same order: nodepool, pod names
and instance-type set of each.

The JAX side runs its XLA rung: conftest pins KARPENTER_NATIVE_CUTOFF=0,
and G·T·K·W stays under SHARD_MIN_WORK, so no mesh.
"""

import importlib

import numpy as np
import pytest

import bench
from karpenter_tpu.models.solver import SHARD_MIN_WORK, TPUSolver
from karpenter_tpu.ops.tensorize import kernel_args as jax_kernel_args
from karpenter_tpu.ops.tensorize import tensorize as jax_tensorize
from karpenter_tpu_torch.models import TorchSolver
from karpenter_tpu_torch.ops import kernels as tkernels
from karpenter_tpu_torch.ops.tensorize import kernel_args, tensorize
from karpenter_tpu_torch.workload import build_workload

N_PODS, N_TYPES = 2000, 60
SNAP_ARRAYS = [
    "g_demand", "g_count", "g_mask", "g_has", "g_tol", "g_tmpl_ok",
    "g_zone_allowed", "g_ct_allowed", "g_bin_cap", "g_single", "g_decl",
    "g_match", "g_sown", "g_smatch", "g_aneed", "g_amatch", "g_tier",
    "t_mask", "t_has", "t_tol", "t_alloc", "t_cap", "t_tmpl", "off_zone",
    "off_ct", "off_avail", "off_price", "m_mask", "m_has", "m_tol",
    "m_overhead", "m_limits", "m_minv",
]


def _extra_pods(pkg: str, variant: str):
    """Pods the variant adds, from the package's own Pod class."""
    objects = importlib.import_module(f"{pkg}.api.objects")
    if variant != "ineligible":
        return []
    # host ports are not expressible on the device: these route to the
    # host FFD loop, seeded with the device-built claims
    return [
        objects.Pod(metadata=objects.ObjectMeta(name=f"hp{i}"),
                    requests={"cpu": 0.5, "memory": 2**30},
                    host_ports=[("0.0.0.0", 8080 + i % 3, "TCP")])
        for i in range(12)
    ]


LIMITS = {"spot": {"cpu": 300.0}}


def jax_side(variant):
    pods, templates, its = bench.build_workload(N_PODS, N_TYPES)
    return pods + _extra_pods("karpenter_tpu", variant), templates, its


def port_side(variant):
    pods, templates, its = build_workload(N_PODS, N_TYPES)
    return pods + _extra_pods("karpenter_tpu_torch", variant), templates, its


def _sorted_templates(templates):
    return sorted(templates, key=lambda t: (-t.weight, t.nodepool_name))


def test_tensorize_arrays_equal():
    jp, jt, jits = jax_side("headline")
    tp, tt, tits = port_side("headline")
    js = jax_tensorize(jp, _sorted_templates(jt), jits)
    ts = tensorize(tp, _sorted_templates(tt), tits)
    assert ts.keys == js.keys and ts.resources == js.resources
    assert ts.W == js.W and ts.vocab == js.vocab
    for name in SNAP_ARRAYS:
        a, b = getattr(js, name), getattr(ts, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert [[p.name for p in g] for g in ts.groups] == [
        [p.name for p in g] for g in js.groups]
    assert [it.name for _, it in ts.type_refs] == [
        it.name for _, it in js.type_refs]
    ja = jax_kernel_args(js)
    ta = kernel_args(ts)
    assert set(ta) == set(ja)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and np.array_equal(ja[k], ta[k]), k
    # the carried-across dict feeds the port's solve_step unchanged
    assert set(tkernels.from_kernel_args(ja, "cpu")) == set(ja)
    Gp, T = ja["g_count"].shape[0], ja["t_mask"].shape[0]
    K, W = ja["g_mask"].shape[1:]
    assert Gp * T * K * W < SHARD_MIN_WORK


def _claims(res):
    return [
        (c.template.nodepool_name, sorted(p.name for p in c.pods),
         sorted(it.name for it in c.instance_types))
        for c in res.new_claims
    ]


@pytest.mark.parametrize("variant", ["headline", "limits", "ineligible"])
def test_torch_solver_matches_tpu_solver(variant):
    limits = LIMITS if variant == "limits" else None
    jp, jt, jits = jax_side(variant)
    tp, tt, tits = port_side(variant)
    jsolver = TPUSolver()
    jres = jsolver.solve(jp, jt, jits, limits=limits)
    assert jsolver.last_device_stats["engine"] == "device"
    tsolver = TorchSolver(device="cpu")
    tres = tsolver.solve(tp, tt, tits, limits=limits)
    assert tsolver.last_device_stats["engine"] == "cpu"
    assert tsolver.last_device_stats["device_pods"] > 0
    assert (tsolver.last_device_stats["host_pods"]
            == jsolver.last_device_stats["host_pods"])
    assert tres.node_count() == jres.node_count()
    assert sorted(tres.pod_errors) == sorted(jres.pod_errors)
    assert _claims(tres) == _claims(jres)
    if variant == "headline":
        assert not tres.pod_errors
        assert tres.scheduled_pod_count() == N_PODS


def _one_per_node(pkg: str, n: int):
    """n pods of 4.1 cpu on an 8-cpu type: one pod per node, so the demand
    bound (about half a node per pod) under-sizes the bin axis — with
    n=600 its 1.5x headroom gives 466 bins, bucketed to 512 — and it
    runs dry."""
    objects = importlib.import_module(f"{pkg}.api.objects")
    nodepool = importlib.import_module(f"{pkg}.api.nodepool")
    catalog = importlib.import_module(f"{pkg}.cloudprovider.catalog")
    inflight = importlib.import_module(f"{pkg}.models.inflight")
    pods = [objects.Pod(metadata=objects.ObjectMeta(name=f"w{i}"),
                        requests={"cpu": 4.1, "memory": 2**30})
            for i in range(n)]
    pool = nodepool.NodePool(metadata=objects.ObjectMeta(name="default"))
    its = {"default": [catalog.make_instance_type("big", 8, 32)]}
    return pods, [inflight.ClaimTemplate(pool)], its


def test_bin_axis_doubling_matches():
    """An estimate that runs dry forces the doubling re-run: the port
    re-runs synchronously and lands on the JAX package's claims."""
    jsolver, tsolver = TPUSolver(), TorchSolver(device="cpu")
    jres = jsolver.solve(*_one_per_node("karpenter_tpu", 600))
    tres = tsolver.solve(*_one_per_node("karpenter_tpu_torch", 600))
    assert tsolver.last_device_stats["bin_growths"] == 1
    assert jsolver.last_device_stats["bin_growths"] == 1
    assert tres.node_count() == jres.node_count() == 600
    assert not tres.pod_errors
    assert _claims(tres) == _claims(jres)


def test_unsupported_inputs_raise():
    """Nothing the solver takes raises any more. ``tier_of`` (the fused
    admission round) splits the groups by tier as the JAX package's does,
    and an empty one solves as no tiers; ``existing_base`` (the
    disruption snapshot) is read only to slice the existing-node tensors,
    so a batch without existing nodes solves as it would without it (its
    parity is in ``test_torch_operator.py``, the tiered solve's in
    ``test_torch_admission.py``)."""
    tp, tt, tits = port_side("headline")
    jp, jt, jits = jax_side("headline")
    solver = TorchSolver(device="cpu")
    want = _claims(solver.solve(tp[:10], tt, tits))
    assert _claims(solver.solve(tp[:10], tt, tits,
                                existing_base=object())) == want
    assert _claims(solver.solve(tp[:10], tt, tits, tier_of={})) == want
    # the last three pods first: their own tier packs ahead of the rest
    got = solver.solve(tp[:10], tt, tits,
                       tier_of={p.uid: 1 for p in tp[7:10]})
    jres = TPUSolver().solve(jp[:10], jt, jits,
                             tier_of={p.uid: 1 for p in jp[7:10]})
    assert _claims(got) == _claims(jres)
    assert [getattr(c, "_tier", None) for c in got.new_claims] == [
        getattr(c, "_tier", None) for c in jres.new_claims]


def test_signatures_match_jax_package():
    """The batch signature pass assembles the canonical pod_signature
    tuple, and both equal the JAX package's for the same specs."""
    from karpenter_tpu.ops.tensorize import pod_signature as jax_pod_signature
    from karpenter_tpu_torch.ops.tensorize import batch_signatures, pod_signature

    jp = _extra_pods("karpenter_tpu", "ineligible") + jax_side("headline")[0][:48]
    tp = (_extra_pods("karpenter_tpu_torch", "ineligible")
          + port_side("headline")[0][:48])
    sigs = batch_signatures(tp)
    assert sigs == [pod_signature(p) for p in tp]
    assert sigs == [jax_pod_signature(p) for p in jp]
    # host ports are not part of the signature: the extra pods share the
    # (0.5 cpu, 1 GiB, no selector) shape's
    assert len(set(sigs)) == 24
