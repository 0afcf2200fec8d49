#!/usr/bin/env python3
"""Run the PyTorch/CUDA port end to end on one GPU and check it.

    python3 chip_smoke.py

from the repository root, on a machine with one CUDA card, ``nvcc`` (under
``$CUDA_HOME``, default ``/usr/local/cuda``) and PyTorch built for CUDA.
It imports nothing of JAX or of ``karpenter_tpu``.

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds every CUDA kernel of the port from ``karpenter_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) and prints the
   compiler's register/shared-memory report.
3. Builds the headline burst — 50,000 pods in 24 deployment shapes, two
   NodePools, ``benchmark_catalog(500)`` — and solves it with
   ``TorchSolver()`` on the card, with every kernel launch count set to 0
   just before and read just after. Every pod must be scheduled and every
   kernel of the path launched: compat 2 + Gp times per dispatch (G×T,
   G×M, and one group row against the bins per pack step).
4. Holds each kernel against its plain PyTorch version on the card, at the
   main path's own inputs (G×T, G×M, one group row × Bp bins), at a scale
   case and at edge shapes (exact equality), and times kernel, plain
   version and bound: ``ms`` is the CUDA-event time per call of
   back-to-back wrapper calls (host launch cost included), ``device_ms``
   the kernels' own time from a torch.profiler trace, ``floor_device_ms``
   the device time of an empty launch, ``wrapper_host_us_1xB`` the host
   cost of one wrapper call at phase B's shape beside its two fixed
   parts (the output allocation and a bare launch).
5. Re-runs the dispatch with host reads forbidden (sync debug mode), then
   on the CPU plain path: assign, assign_e, used, tmpl, F, price must be
   bit-equal, and a CPU solve must open the same number of nodes. Times
   the LP bin floor (``ops/relax.py``), which sizes the headline's bin
   axis on the card as the JAX package's does on an accelerator.
6. The live round, the second main path: the headline's claims launched
   as a 1,128-node cluster (``workload.live_cluster``) and 5,000 pods of
   the upstream scheduling benchmark's 1/6 constraint mix (seed 42)
   provisioned onto it with ``TorchSolver()``, a real ``Topology`` and
   every node an ``ExistingNode`` — the waves compiler, phase A on the
   existing nodes, the class gates, the existing-node decode and the
   topology commit — with the launch counts set to 0 just before and read
   just after. Every pod must be placed or fail as a pod error; no node
   may exceed its allocatable and no two pods of the anti-affinity
   cohort may share a node. The round's last dispatch is re-run on the
   card (sync debug mode) and on the CPU plain path, bit-equal, and its
   own G×T and 1×Bp products join the compat cases.
7. The consolidation probe, the third main path, on two fleets that
   ``workload.underutilized_fleet`` builds with ``TorchSolver()``:
   **global** (2,000 nodes, one 5-cpu pod each: ``perf/run.py``'s global
   consolidation fleet) through ``batched_feasible_prefix`` (the first
   100 candidates), ``batched_single_feasible`` (all) and
   ``joint_retirement_plan(want_singles=True)`` with the LP relax rung
   off (the FFD ladder: prefix rows plus single rows) and on; and
   **global-xl** (10,000 nodes × 128 groups, 9,984 nodes) through one
   joint round with the relax rung on over the 4,096 cheapest
   budget-allowed candidates, which must ship through the rung. Each
   call runs with the launch counts set to 0 just before and read just
   after (compat must launch 2 + Gp times per chunk wherever rows are
   dispatched); every row dispatch is re-run on the CPU plain path
   (bit-equal ``placed_g`` and ``used``) and every relax decision too
   (the same ship or fallback cause, selection and displacement); every
   answer is checked against the store in exact arithmetic (no survivor
   over its allocatable, every displaced pod placed, no pod on a
   retiree). A chunk of the ladder and the relax LP are traced, and the
   probe's own G×T and 1×(Np·Bp) products join the compat cases.

Prints one ``{"kernels": [...]}`` line, one ``{"solve": ...}`` line, one
``{"live_round": ...}`` line, one ``{"consolidation": ...}`` line, the
card line, and as its last line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# published H100 SXM peaks (dense): HBM bytes/s and the float32 rate
# outside the tensor cores, against which integer/logic ops are counted
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12

N_PODS, N_TYPES = 50_000, 500
LIVE_PODS, LIVE_SEED = 5_000, 42
# the consolidation fleets (perf/run.py run_global_consolidation's
# PERF_GLOBAL_NODES default, and run_global_xl's config4_xl_env(10000,
# 128)) and the disruption methods' candidate caps
# (karpenter_tpu/controllers/disruption/methods.py)
GLOBAL_NODES = 2_000
XL_NODES, XL_GROUPS = 10_000, 128
MULTI_NODE_CANDIDATE_CAP = 100
GLOBAL_CANDIDATE_CAP = 4096
STEP_OUTPUTS = ("assign", "assign_e", "used", "tmpl", "F", "price", "npods")

# compat cases beside the main path's own inputs, (G, T, K, W): a cluster
# of ~512 pod shapes over 8 NodePools of the 500-type catalog, and edge
# shapes (W=1 with K=128, ragged rows, a tile that streams the key axis
# through more than 48 KB of shared memory, tall and thin products)
SCALE_SHAPE = (512, 4096, 9, 16)
EDGE_SHAPES = [(8, 128, 128, 1), (1, 1, 1, 1), (7, 129, 5, 3),
               (33, 1000, 17, 2), (100, 50, 3, 40), (9, 300, 64, 32),
               (1, 1536, 9, 16), (3, 70, 5, 3), (2, 33, 128, 32),
               (600, 40, 2, 1)]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events, after a warm-up."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def _trace(fn, reps: int, cross_check: bool = False):
    """``{kernel name: (µs, records)}`` over a trace of ``reps`` calls and
    the traced wall time, from the profiler's raw device records.
    ``key_averages`` takes minutes over the ~1.5M records of the live
    round's dispatch; with ``cross_check`` its device total is computed
    too and must agree."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        us, n = by_name.get(ev.name(), (0.0, 0))
        by_name[ev.name()] = (us + ev.duration_ns() / 1e3, n + 1)
    if cross_check:
        total = 0.0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                us = getattr(ev, "self_device_time_total", None)
                total += ev.self_cuda_time_total if us is None else us
        mine = sum(us for us, _ in by_name.values())
        check(abs(total - mine) <= 0.01 * max(total, 1e-9),
              f"profiler totals disagree: raw records {mine} us, "
              f"key_averages {total} us")
    return by_name, wall_us


def device_times(fn, reps: int, kernel: str | None = None,
                 cross_check: bool = False, warm_up: bool = True) -> dict | None:
    """Device time per call from a torch.profiler trace of ``reps`` calls
    after a warm-up: total kernel time per call, or, with ``kernel``, the
    mean of the recorded launches of the kernels whose name holds it (the
    functions timed that way launch it once per call); kernels launched,
    the busy share of the traced wall time, and the largest kernel times
    by name. ``recorded`` is the wanted kernel's records per call: a
    trace can drop records (one of ~33k, seen), and can come back without
    the wanted kernel at all (seen for the ctypes-launched kernels): it is
    then taken again, up to three times, and None is reported if it never
    shows."""
    import torch

    if warm_up:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        by_name, wall_us = _trace(fn, reps, cross_check)
        mine = [v for k, v in by_name.items() if kernel is None or kernel in k]
        mine_us = sum(us for us, _ in mine)
        if mine_us > 0:
            break
    else:
        return None
    mine_n = sum(n for _, n in mine)
    total_us = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"device_ms": (mine_us / mine_n if kernel else total_us / reps) / 1e3,
            "recorded": mine_n / reps,
            "wall_ms": wall_us / reps / 1e3,
            "kernels": sum(n for _, n in by_name.values()) / reps,
            "busy": total_us / wall_us,
            "top_us": {k[:60]: us / reps for k, (us, _) in top}}


def compat_case(rng, G, T, K, W, device):
    import torch

    def rows(n):
        m = rng.integers(-(2**31), 2**31 - 1, size=(n, K, W), dtype=np.int32)
        m[rng.random((n, K, W)) < 0.7] = 0b0101 if n == G else 0b1010
        return (torch.from_numpy(m).to(device),
                torch.from_numpy(rng.random((n, K)) < 0.6).to(device),
                torch.from_numpy(rng.random((n, K)) < 0.2).to(device))

    gm, gh, gt = rows(G)
    tm, th, tt = rows(T)
    return gm, gh, gt, tm, th, tt


def compat_bound_ms(gm, gh, tm, th) -> tuple:
    """Least time for one compat call: each input byte read once and each
    output byte written once at HBM rate, against the logic operations
    this data needs (2W+3 for each key that both the group row and the
    type define; a key either leaves undefined is true with no word
    read) at the vector rate; the larger of the two, and which one it
    is."""
    import torch

    G, _, W = gm.shape
    T = tm.shape[0]
    in_bytes = sum(x.numel() * x.element_size() for x in (gm, gh, tm, th))
    in_bytes += gh.numel() + th.numel()  # the tol rows, one byte per key
    out_bytes = G * T
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    pairs = gh.sum(0, dtype=torch.int64) * th.sum(0, dtype=torch.int64)
    ops = int(pairs.sum()) * (2 * W + 3)
    ops_ms = ops / VECTOR_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def bins_case(args, G, B, kernels):
    """Pack phase B's compat inputs at the headline: the group row that
    defines the most keys against B bin rows, each the requirements a
    fresh bin carries (template row ∧ a group row, as ``pack`` opens it),
    no tolerance."""
    import torch

    dev = args["g_mask"].device
    g = int(args["g_has"][:G].sum(1).argmax())
    gi = torch.arange(B, device=dev) % G
    mi = torch.arange(B, device=dev) % args["m_mask"].shape[0]
    bmask, bhas = kernels._combine_masks(
        args["m_mask"][mi], args["m_has"][mi],
        args["g_mask"][gi], args["g_has"][gi])
    K = bhas.shape[1]
    return [args["g_mask"][g:g + 1].contiguous(),
            args["g_has"][g:g + 1].contiguous(),
            torch.zeros((1, K), dtype=torch.bool, device=dev),
            bmask.contiguous(), bhas.contiguous(),
            torch.zeros((B, K), dtype=torch.bool, device=dev)]


def time_compat(inp, cuda_kernels) -> dict:
    """Kernel, plain version and bound for one compat case."""
    bound, by = compat_bound_ms(inp[0], inp[1], inp[3], inp[4])
    kern = device_times(lambda: cuda_kernels.compat(*inp), 50,
                        kernel="compat_kernel")
    plain = device_times(lambda: cuda_kernels.compat_reference(*inp), 20)
    ms = time_ms(lambda: cuda_kernels.compat(*inp))
    device_ms = kern and kern["device_ms"]
    return dict(
        ms=ms, us=ms * 1e3,
        plain_ms=time_ms(lambda: cuda_kernels.compat_reference(*inp),
                         reps=10, inner=5),
        device_ms=device_ms,
        plain_device_ms=plain and plain["device_ms"],
        plain_kernels=plain and plain["kernels"],
        bound_ms=bound, bound_by=by,
        bound_share=bound / device_ms if device_ms else None)


def wrapper_host_us(inp, cuda_kernels, n: int = 2000) -> dict:
    """Host microseconds per call, by the host clock over ``n`` calls
    without a sync between them: the whole compat wrapper, the output
    allocation alone, and a bare ctypes launch of the empty kernel."""
    import torch

    dev = inp[0].device
    G, T = inp[0].shape[0], inp[3].shape[0]
    lib = cuda_kernels._lib("compat")
    stream = cuda_kernels._stream(dev.index)
    pieces = {
        "compat": lambda: cuda_kernels.compat(*inp),
        "torch_empty": lambda: torch.empty((G, T), dtype=torch.bool,
                                           device=dev),
        "empty_launch": lambda: lib.karpenter_compat_noop(stream),
    }
    out = {}
    for name, fn in pieces.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return out


def check_dispatch(args_gpu, step_kw, kernels, label: str) -> tuple:
    """Re-run one dispatch on the card with host reads forbidden (sync
    debug mode), then on the CPU plain path: every integer output and the
    price must be bit-equal. Returns the card's dispatch time by CUDA
    events (ms) and the CPU dispatch's host time (ms)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        out_gpu = kernels.solve_step(args_gpu, **step_kw)
        stop.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    stop.synchronize()
    args_cpu = {k: v.cpu() for k, v in args_gpu.items()}
    t0 = time.perf_counter()
    out_cpu = kernels.solve_step(args_cpu, **step_kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    for key in STEP_OUTPUTS:
        a, b = out_gpu[key].cpu().numpy(), out_cpu[key].numpy()
        check(a.shape == b.shape and np.array_equal(a, b),
              f"{label}: cuda and cpu solve_step differ in {key}")
    return start.elapsed_time(stop), cpu_ms


def live_round_phase(claims, templates, its, cuda_kernels, kernels) -> tuple:
    """The live round on the card: ``(live_line, cases, launches,
    trace)`` — the printed record, the round's own compat inputs (its
    last dispatch's G×T and 1×Bp products), the launch counts of the run,
    and a function that adds the dispatch's profiler trace to the
    record."""
    import torch

    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.ops.tensorize import bucket
    from karpenter_tpu_torch.utils import resources as resutil
    from karpenter_tpu_torch.workload import live_round

    t0 = time.perf_counter()
    burst, topology, existing = live_round(claims, templates, its,
                                           n_pods=LIVE_PODS, seed=LIVE_SEED)
    build_ms = (time.perf_counter() - t0) * 1e3
    solver = TorchSolver()
    # the round's dispatches, as the solver issues them
    dispatches = []
    real_step = kernels.solve_step

    def recording_step(args, **kw):
        dispatches.append((args, kw))
        return real_step(args, **kw)

    kernels.solve_step = recording_step
    cuda_kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        res = solver.solve(burst, templates, its, topology=topology,
                           existing_nodes=existing)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        kernels.solve_step = real_step
    launches = dict(cuda_kernels.LAUNCHES)
    stats = dict(solver.last_device_stats)

    scheduled = res.scheduled_pod_count()  # claims' and existing nodes'
    check(scheduled + len(res.pod_errors) == LIVE_PODS,
          f"live round: {scheduled} placed + {len(res.pod_errors)} errors "
          f"!= {LIVE_PODS} pods")
    check(stats["engine"] == "cuda" and stats["device_pods"] > 0,
          f"live round left the card: {stats}")
    check(stats["existing"] == len(claims),
          f"live round saw {stats['existing']} of {len(claims)} nodes")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the live round")
    check(launches["compat"] == (2 + stats["Gp"]) * len(dispatches),
          f"live round: compat launches {launches['compat']} != 2 + Gp = "
          f"{2 + stats['Gp']} per dispatch over {len(dispatches)} dispatches")
    check(stats["Gp"] == bucket(stats["groups"]), "live round: Gp off bucket")
    for holder in list(res.new_claims) + existing:
        # the mix's anti-affinity cohort: one app=nginx pod per hostname
        cohort = sum(1 for p in holder.pods
                     if p.metadata.labels.get("app") == "nginx")
        check(cohort <= 1, f"{cohort} app=nginx pods share {holder}")
    for node in existing:
        check(resutil.fits(node.requests, node.cached_available),
              f"existing node over its allocatable: {node}")
    for claim in res.new_claims:
        check(claim.instance_types and all(
            resutil.fits(claim.requests, it.allocatable())
            for it in claim.instance_types),
            f"a claim's requests do not fit its instance types: {claim}")

    # the round's last dispatch, again: on the card and on the CPU
    args_gpu, step_kw = dispatches[-1]
    t0 = time.perf_counter()
    gpu_ms, cpu_ms = check_dispatch(args_gpu, step_kw, kernels, "live round")
    check_s = time.perf_counter() - t0

    G = stats["groups"]
    cases = [("live GxT", [args_gpu[k] for k in (
                 "g_mask", "g_has", "g_tol", "t_mask", "t_has", "t_tol")]),
             ("live 1xB", bins_case(args_gpu, G, step_kw["max_bins"],
                                    kernels))]
    line = {"live_round": {
        "cluster_nodes": len(claims), "pods": LIVE_PODS, "seed": LIVE_SEED,
        "build_ms": build_ms, "wall_ms": wall_ms,
        **{k: stats.get(k) for k in (
            "waves_compile_ms", "tensorize_ms", "solve_ms", "decode_ms")},
        "G": G, "Gp": stats["Gp"], "E": stats["existing"], "Ep": stats["Ep"],
        "T": stats["types"], "B": stats["B"], "Bp": stats["bins"],
        "bin_growths": stats.get("bin_growths", 0),
        "dispatches": len(dispatches),
        "lp_floor": stats["floor"], "lp_led": stats["lp_led"],
        "existing_pods": stats["existing_pods"],
        "device_pods": stats["device_pods"], "host_pods": stats["host_pods"],
        "retry_pods": stats["retry_pods"],
        "host_routed": stats["host_routed"],
        "pods_scheduled": scheduled, "nodes": res.node_count(),
        "pod_errors": len(res.pod_errors),
        "compat_launches": launches["compat"],
        "solve_step_gpu_ms": gpu_ms,
        "solve_step_cpu_ms": cpu_ms,
        "check_s": check_s,
    }}

    def trace():
        """The dispatch under torch.profiler: kernels per dispatch and the
        busy share. Taken after every other device timing of the run:
        CUPTI keeps ~1.5M records for it, and timings traced after it
        came back short."""
        t0 = time.perf_counter()
        line["live_round"]["solve_step_trace"] = device_times(
            lambda: kernels.solve_step(args_gpu, **step_kw), 1, warm_up=False)
        line["live_round"]["trace_s"] = time.perf_counter() - t0

    return line, cases, launches, trace


class BundleMemo:
    """The entry points' snapshot-cache seam: the first call on a fleet
    builds the ``DisruptionSnapshot`` (timed), later calls get the same
    one."""

    def __init__(self, cons):
        self.cons = cons
        self.bundle = None
        self.build_ms = 0.0

    def get(self, provisioner, cluster, store, candidates, registry=None):
        if self.bundle is None:
            t0 = time.perf_counter()
            self.bundle = self.cons.build_disruption_snapshot(
                provisioner, cluster, store, candidates)
            self.build_ms = (time.perf_counter() - t0) * 1e3
        return self.bundle


def check_plan_in_store(store, plan, bundle, label: str) -> None:
    """A joint plan against the store, in exact arithmetic: no pod lands
    on a retiree, every pod of a retiree is placed (on a survivor or the
    claims' overflow), no survivor goes over its allocatable."""
    retired = {c.provider_id for c in plan.selected}
    nodes = {n.provider_id: n for n in store.list("nodes")}
    pid_of = {n.name: n.provider_id for n in nodes.values()}
    used = {pid: {} for pid in nodes}
    displaced = 0
    for p in store.list("pods"):
        if not p.node_name:
            continue
        pid = pid_of[p.node_name]
        if pid in retired:
            displaced += 1
            continue
        for r, v in p.requests.items():
            used[pid][r] = used[pid].get(r, 0.0) + v
    placed = sum(plan.overflow.values())
    for pid, g, count in plan.displacement:
        check(pid not in retired, f"{label}: a pod lands on retiree {pid}")
        placed += count
        for r, v in bundle.snap.group_demand[g].items():
            used[pid][r] = used[pid].get(r, 0.0) + count * v
    check(placed == displaced,
          f"{label}: {placed} pods placed of {displaced} displaced")
    for pid, node in nodes.items():
        for r, v in used[pid].items():
            check(v <= node.allocatable.get(r, 0.0) + 1e-6,
                  f"{label}: {pid} over its allocatable in {r}")


def consolidation_phase(cuda_kernels, kernels) -> tuple:
    """The consolidation probe on the card: ``(line, cases, launches)``
    — the printed record, the probe's own compat inputs, and the compat
    launches of every call."""
    import os

    import torch

    from karpenter_tpu_torch.api.nodepool import REASON_UNDERUTILIZED
    from karpenter_tpu_torch.controllers.disruption.helpers import (
        build_disruption_budgets,
        within_budget,
    )
    from karpenter_tpu_torch.ops import consolidate as cons
    from karpenter_tpu_torch.ops import relax
    from karpenter_tpu_torch.workload import underutilized_fleet

    real_dispatch = cons.dispatch_counterfactual_rows
    real_relax, real_lp = relax.joint_relax_plan, relax.joint_lp
    dispatches, decisions, lps = [], [], []

    def recording_dispatch(shared, Gp, Ep, e_avail, max_minv, g_count_k,
                           e_zero_cols, e_free=None, max_bins=1):
        t0 = time.perf_counter()
        out = real_dispatch(shared, Gp, Ep, e_avail, max_minv, g_count_k,
                            e_zero_cols, e_free=e_free, max_bins=max_bins)
        dispatches.append(dict(
            args=(shared, Gp, Ep, e_avail, max_minv, g_count_k, e_zero_cols),
            max_bins=max_bins, out=out,
            ms=(time.perf_counter() - t0) * 1e3))
        return out

    def recording_relax(bundle, candidates, col_arr, contrib, cum, timings,
                        device=None):
        plan, cause = real_relax(bundle, candidates, col_arr, contrib, cum,
                                 timings, device=device)
        decisions.append(dict(
            inputs=(bundle, candidates, col_arr, contrib, cum),
            plan=plan, cause=cause, k_ub=relax.RELAX_STATS["last_k_ub"],
            k_frac=relax.RELAX_STATS["last_k_frac"],
            iters=relax.RELAX_STATS["last_iters"], timings=dict(timings),
            ships=relax.RELAX_STATS["ships"]))
        return plan, cause

    def recording_lp(t, max_iters, tol, rho):
        if t["d"].is_cuda:  # not the CPU re-run's
            lps.append((t, max_iters, tol, rho))
        return real_lp(t, max_iters, tol, rho)

    def relax_decision(plan, cause):
        if plan is None:
            return ("fallback", cause)
        return ("ship", list(plan.selected_idx), plan.displacement,
                plan.overflow, plan.n_claims)

    def run(label, fn, knob, memo):
        """One entry-point call with the launch counts zeroed just before
        and read just after, its row dispatches re-run on the CPU plain
        path and its relax decision re-made there."""
        os.environ["KARPENTER_RELAX"] = knob
        dispatches.clear()
        decisions.clear()
        built_here = memo.bundle is None
        cuda_kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(cuda_kernels.LAUNCHES)
        for name, n in launches.items():
            total_launches[name] += n
        check(result is not None, f"{label}: the probe could not express "
                                  "the fleet")
        rows = sum(d["args"][5].shape[0] for d in dispatches)
        chunks = sum(-(-d["args"][5].shape[0] // cons.PROBE_CHUNK_ROWS)
                     for d in dispatches)
        Gp = dispatches[0]["args"][1] if dispatches else None
        if dispatches:
            check(launches["compat"] == chunks * (2 + Gp),
                  f"{label}: compat launches {launches['compat']} != "
                  f"(2 + Gp) × {chunks} chunks")
        else:
            check(launches["compat"] == 0, f"{label}: compat launched "
                                           "with no rows dispatched")
        # the CPU plain path, dispatch by dispatch: bit-equal
        cpu_ms = 0.0
        for d in dispatches:
            shared, Gp_, Ep, e_avail, mm, gk, cols = d["args"]
            t1 = time.perf_counter()
            want = real_dispatch({k: v.cpu() for k, v in shared.items()},
                                 Gp_, Ep, e_avail, mm, gk, cols,
                                 max_bins=d["max_bins"])
            cpu_ms += (time.perf_counter() - t1) * 1e3
            for a, b in zip(d["out"], want):
                check(a.shape == b.shape and np.array_equal(a, b),
                      f"{label}: cuda and cpu probe rows differ")
        rec = dict(rows=rows, chunks=chunks, wall_ms=wall_ms,
                   snapshot_ms=memo.build_ms if built_here else 0.0,
                   dispatch_ms=sum(d["ms"] for d in dispatches),
                   compat_launches=launches["compat"],
                   compat_per_chunk=(launches["compat"] / chunks
                                     if chunks else 0),
                   cpu_dispatch_ms=cpu_ms)
        for dec in decisions:
            t1 = time.perf_counter()
            cpu_plan, cpu_cause = real_relax(*dec["inputs"], {},
                                             device="cpu")
            rec["relax_cpu_ms"] = (time.perf_counter() - t1) * 1e3
            check(relax_decision(cpu_plan, cpu_cause)
                  == relax_decision(dec["plan"], dec["cause"]),
                  f"{label}: the relax rung decides differently on the "
                  f"card ({dec['cause']}) and the CPU ({cpu_cause})")
            rec.update(relax_cause=dec["cause"] or "shipped",
                       k_ub=dec["k_ub"], k_ub_cpu=relax.RELAX_STATS[
                           "last_k_ub"],
                       lp_objective=dec["k_frac"],
                       lp_objective_cpu=relax.RELAX_STATS["last_k_frac"],
                       pdhg_iters=dec["iters"],
                       pdhg_blocks=dec["timings"].get("relax_blocks"),
                       pdhg_wall_ms=dec["timings"].get("relax_lp_ms"),
                       round_ms=dec["timings"].get("relax_round_ms"))
            check(rec["k_ub"] == rec["k_ub_cpu"],
                  f"{label}: k_ub {rec['k_ub']} on the card, "
                  f"{rec['k_ub_cpu']} on the CPU")
        rec["criteria_ms"] = (wall_ms - rec["snapshot_ms"]
                              - rec["dispatch_ms"]
                              - sum(d["timings"].get("relax_ms", 0.0)
                                    for d in decisions))
        return result, rec

    cons.dispatch_counterfactual_rows = recording_dispatch
    relax.joint_relax_plan, relax.joint_lp = recording_relax, recording_lp
    knob = os.environ.get("KARPENTER_RELAX")
    total_launches = {name: 0 for name in cuda_kernels.LAUNCHES}
    fleets: dict = {}
    traces: dict = {}
    try:
        # ---- global: 2,000 nodes ----
        t0 = time.perf_counter()
        store, cluster, prov, pool = underutilized_fleet(GLOBAL_NODES)
        build_ms = (time.perf_counter() - t0) * 1e3
        check(prov.solver.device.type == "cuda", "fleet solver not on cuda")
        memo = BundleMemo(cons)
        calls = {}
        capped = pool[:MULTI_NODE_CANDIDATE_CAP]
        (k, definitive), calls["prefix"] = run(
            "global prefix", lambda: cons.batched_feasible_prefix(
                prov, cluster, store, capped, cache=memo,
                build_candidates=pool), "0", memo)
        bundle = memo.bundle
        check(k >= 2 and definitive, f"global prefix: k={k}, "
                                     f"definitive={definitive}")
        # the answer itself: the first k candidates' pods place exactly
        cols = np.asarray(bundle.columns_for(capped))
        contrib = bundle.contribs_for(capped)
        surv = np.asarray(bundle.esnap.live, bool).copy()
        surv[cols[:k]] = False
        check(cons._greedy_displace(
            bundle, surv, contrib[:k].sum(0), allow_claim=True) is not None,
            f"global prefix: candidates[:{k}] do not place exactly")
        calls["prefix"].update(k=k, definitive=definitive)
        prefix_ladder = dispatches[0]
        (mask, definitive), calls["single"] = run(
            "global single", lambda: cons.batched_single_feasible(
                prov, cluster, store, pool, cache=memo), "0", memo)
        check(mask.any(), "global single: no candidate consolidates")
        calls["single"].update(feasible=int(mask.sum()),
                               definitive=definitive)
        for name, knob_v in (("ladder", "0"), ("relax", "1")):
            plan, calls[name] = run(
                f"global {name}", lambda: cons.joint_retirement_plan(
                    prov, cluster, store, pool, cache=memo,
                    want_singles=True), knob_v, memo)
            check(plan.viable, f"global {name}: {plan.reason}")
            check_plan_in_store(store, plan, bundle, f"global {name}")
            if name == "ladder":
                check(plan.solver == "ladder" and not plan.relax_fallback,
                      "global ladder: the relax rung ran with it off")
                ladder = dispatches[0]
            calls[name].update(
                selected=len(plan.selected_idx), definitive=plan.definitive,
                solver=plan.solver, relax_fallback=plan.relax_fallback,
                delete_only=plan.delete_only, k_device=plan.k_device)
        fleets["global"] = dict(
            nodes=GLOBAL_NODES, candidates=len(pool), G=bundle.snap.G,
            Gp=prefix_ladder["args"][1], Ep=prefix_ladder["args"][2],
            T=bundle.snap.T, E=bundle.esnap.E, build_ms=build_ms,
            snapshot_ms=memo.build_ms, calls=calls)

        # the ladder's first chunk, at 128 rows and at 4, under the
        # profiler (kernels per chunk whatever its rows), after one call
        # with host reads forbidden
        shared, Gp, Ep, e_avail, mm, gk, cols_k = ladder["args"]
        e_master = torch.zeros((Ep, e_avail.shape[1]), device="cuda")
        e_master[:e_avail.shape[0]] = torch.from_numpy(
            np.asarray(e_avail, np.float32)).cuda()
        for label, rows in (("chunk_128", min(cons.PROBE_CHUNK_ROWS,
                                                len(gk))),
                            ("chunk_4", 4)):
            varying = cons.chunk_rows(e_master, gk, cols_k, None, 0, rows, Gp)
            torch.cuda.set_sync_debug_mode("error")
            try:
                kernels.probe_step(varying, shared, ladder["max_bins"], mm)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            traces[label] = device_times(
                lambda: kernels.probe_step(varying, shared,
                                           ladder["max_bins"], mm), 3)
        lp_global = lps[-1]
        Np = cons._pow2(cons.PROBE_CHUNK_ROWS, lo=4)
        cases = [("probe GxT", [shared[k] for k in (
                     "g_mask", "g_has", "g_tol", "t_mask", "t_has",
                     "t_tol")]),
                 ("probe 1xNpB", bins_case(shared, bundle.snap.G,
                                           Np * ladder["max_bins"],
                                           kernels))]
        del store, cluster, prov, pool, memo, bundle

        # ---- global-xl: 10,000 nodes × 128 groups ----
        t0 = time.perf_counter()
        store, cluster, prov, pool = underutilized_fleet(XL_NODES, XL_GROUPS)
        build_ms = (time.perf_counter() - t0) * 1e3
        budgets = build_disruption_budgets(cluster, store, prov.clock)
        cands = within_budget(budgets, REASON_UNDERUTILIZED,
                              pool)[:GLOBAL_CANDIDATE_CAP]
        memo = BundleMemo(cons)
        ships = relax.RELAX_STATS["ships"]
        lps.clear()
        plan, rec = run(
            "global-xl relax", lambda: cons.joint_retirement_plan(
                prov, cluster, store, cands, cache=memo,
                build_candidates=pool), "1", memo)
        check(decisions[0]["ships"] == ships + 1 and plan.viable
              and plan.solver == "relax",
              f"global-xl: the relax rung did not ship ({plan.reason}, "
              f"{relax.RELAX_STATS['last_fallback']})")
        check_plan_in_store(store, plan, memo.bundle, "global-xl relax")
        rec.update(selected=len(plan.selected_idx), solver=plan.solver,
                   relax_fallback=plan.relax_fallback,
                   definitive=plan.definitive, delete_only=plan.delete_only)
        # the relax LPs of both fleets under the profiler, and by CUDA
        # events
        for label, (t, iters, tol, rho) in (("pdhg_global", lp_global),
                                            ("pdhg_xl", lps[-1])):
            traces[label] = device_times(
                lambda: real_lp(t, iters, tol, rho), 3)
            traces[label + "_event_ms"] = time_ms(
                lambda: real_lp(t, iters, tol, rho), reps=5, inner=1)
        t = lps[-1][0]
        fleets["global_xl"] = dict(
            nodes=len(store.list("nodes")), candidates=len(cands),
            pool=len(pool), G=memo.bundle.snap.G, E=memo.bundle.esnap.E,
            Ec=int(t["capR"].shape[0]), Np=int(t["w"].shape[0]),
            build_ms=build_ms, snapshot_ms=memo.build_ms,
            calls={"relax": rec})
    finally:
        cons.dispatch_counterfactual_rows = real_dispatch
        relax.joint_relax_plan, relax.joint_lp = real_relax, real_lp
        if knob is None:
            os.environ.pop("KARPENTER_RELAX", None)
        else:
            os.environ["KARPENTER_RELAX"] = knob
    line = {"consolidation": {**fleets, "traces": traces}}
    return line, cases, total_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.ops import cuda_kernels, kernels, relax
    from karpenter_tpu_torch.ops.tensorize import bucket, kernel_args, tensorize
    from karpenter_tpu_torch.utils import resources as resutil
    from karpenter_tpu_torch.workload import build_workload

    t_script = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)

    # ---- build every kernel ----
    t0 = time.perf_counter()
    cuda_kernels.build()
    build_s = time.perf_counter() - t0
    for name, log in cuda_kernels.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "error" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    print(f"build: {build_s:.3f} s", flush=True)

    # ---- the main path: the headline burst on the card ----
    pods, templates, its = build_workload(N_PODS, N_TYPES)
    solver = TorchSolver()
    check(solver.device.type == "cuda", "TorchSolver() did not pick cuda")
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    res = solver.solve(pods, templates, its)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    stats = dict(solver.last_device_stats)
    check(not res.pod_errors, f"{len(res.pod_errors)} pods failed to schedule")
    check(res.scheduled_pod_count() == N_PODS,
          f"scheduled {res.scheduled_pod_count()} of {N_PODS} pods")
    check(stats["device_pods"] == N_PODS and stats["host_pods"] == 0,
          f"pods left the device path: {stats}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    n_dispatch = 1 + stats.get("bin_growths", 0)
    Gp = bucket(stats["groups"])  # pack steps per dispatch
    check(launches["compat"] == (2 + Gp) * n_dispatch,
          f"compat launches {launches['compat']} != 2 + Gp = {2 + Gp} "
          f"per dispatch over {n_dispatch} dispatches")
    for claim in res.new_claims:
        check(claim.instance_types and all(
            resutil.fits(claim.requests, it.allocatable())
            for it in claim.instance_types),
            f"a claim's requests do not fit its instance types: {claim}")

    # warm second solve of fresh pods: the steady-state stage times
    pods2, templates2, its2 = build_workload(N_PODS, N_TYPES)
    t0 = time.perf_counter()
    res2 = solver.solve(pods2, templates2, its2)
    warm_s = time.perf_counter() - t0
    warm = dict(solver.last_device_stats)
    check(res2.node_count() == res.node_count(), "warm solve differs")

    # ---- the same snapshot, tensor by tensor ----
    tpl_sorted = sorted(templates2, key=lambda t: (-t.weight, t.nodepool_name))
    snap = tensorize(pods2, tpl_sorted, its2)
    plan = solver.plan(snap)
    Bp = stats["bins"]
    check(plan["floor"] == stats["floor"] and plan["lp_led"] == stats["lp_led"],
          f"plan of the headline snapshot {plan} differs from the solve's")
    args_np = kernel_args(snap, Gp=plan["Gp"], Tp=plan["Tp"])
    args_gpu = kernels.from_kernel_args(args_np, dev)
    step_kw = dict(max_bins=Bp, with_existing=False,
                   level_bits=plan["level_bits"], max_minv=plan["max_minv"])
    _, cpu_step_ms = check_dispatch(args_gpu, step_kw, kernels, "headline")
    gpu_step_ms = time_ms(lambda: kernels.solve_step(args_gpu, **step_kw),
                          reps=5, inner=2)
    step_trace = device_times(lambda: kernels.solve_step(args_gpu, **step_kw), 3,
                              cross_check=True)

    # the LP bin floor on the card, at the headline's inputs
    floor_in = [torch.from_numpy(a).to(dev) for a in relax.floor_inputs(snap)]
    floor_kw = dict(max_iters=relax._relax_max_iters(), tol=relax._relax_tol(),
                    rho=relax._relax_rho())
    lb, floor_iters = relax.floor_lb(*floor_in, **floor_kw)
    lb_cpu, _ = relax.floor_lb(*(x.cpu() for x in floor_in), **floor_kw)
    check(abs(float(lb) - float(lb_cpu)) <= 1e-4 * max(abs(float(lb_cpu)), 1.0),
          f"LP floor bound on the card {float(lb)} != CPU {float(lb_cpu)}")
    floor_trace = device_times(lambda: relax.floor_lb(*floor_in, **floor_kw), 3)

    cpu_solver = TorchSolver(device="cpu")
    pods3, templates3, its3 = build_workload(N_PODS, N_TYPES)
    res_cpu = cpu_solver.solve(pods3, templates3, its3)
    check(res_cpu.node_count() == res.node_count(),
          f"node count cuda {res.node_count()} != cpu {res_cpu.node_count()}")

    # ---- the second main path: the live round on the headline's cluster ----
    live_line, live_cases, live_launches, live_trace = live_round_phase(
        res.new_claims, templates, its, cuda_kernels, kernels)

    # ---- the third main path: the consolidation probe ----
    t0 = time.perf_counter()
    cons_line, cons_cases, cons_launches = consolidation_phase(
        cuda_kernels, kernels)
    cons_line["consolidation"]["phase_s"] = time.perf_counter() - t0

    # ---- every kernel against its plain version, on the card ----
    _, K, W = args_gpu["g_mask"].shape
    gt_in = [args_gpu[k] for k in ("g_mask", "g_has", "g_tol",
                                   "t_mask", "t_has", "t_tol")]
    gm_in = gt_in[:3] + [args_gpu[k] for k in ("m_mask", "m_has", "m_tol")]
    rng = np.random.default_rng(0)
    timed = [("main GxT", gt_in), ("main GxM", gm_in),
             ("main 1xB", bins_case(args_gpu, snap.G, Bp, kernels)),
             *live_cases, *cons_cases,
             ("scale " + "x".join(map(str, SCALE_SHAPE)),
              compat_case(rng, *SCALE_SHAPE, dev))]
    cases = timed + [("x".join(map(str, shape)), compat_case(rng, *shape, dev))
                     for shape in EDGE_SHAPES]
    shapes = []
    mismatches = 0
    for label, inp in cases:
        got = cuda_kernels.compat(*inp)
        want = cuda_kernels.compat_reference(*inp)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        mismatches += bad
        shape = (inp[0].shape[0], inp[3].shape[0], *inp[0].shape[1:])
        entry = dict(case=label, shape=list(shape),
                     tile=cuda_kernels.compat_tile(*shape)._asdict(),
                     mismatches=bad)
        if any(label == name for name, _ in timed):
            entry.update(time_compat(inp, cuda_kernels))
        shapes.append(entry)
    check(mismatches == 0, f"compat kernel disagrees with its plain version "
                           f"in {mismatches} cells: {shapes}")
    floor = device_times(lambda: cuda_kernels.compat_noop(dev), 50,
                         kernel="noop_kernel")
    host_us = wrapper_host_us(timed[2][1], cuda_kernels)
    live_trace()
    main_gt = shapes[0]
    kernels_line = {"kernels": [{
        "name": "compat",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/compat.cu",
        "replaces": "karpenter_tpu/ops/pallas_kernels.py:62",
        "launches": (launches["compat"] + live_launches["compat"]
                     + cons_launches["compat"]),
        "launches_by_path": {"headline": launches["compat"],
                             "live_round": live_launches["compat"],
                             "consolidation": cons_launches["compat"]},
        "max_abs_err": 0 if mismatches == 0 else 1,
        "tolerance": "exact (one bool per cell)",
        "mismatches": mismatches,
        "ms": main_gt["ms"],
        "us": main_gt["us"],
        "device_ms": main_gt["device_ms"],
        "plain_ms": main_gt["plain_ms"],
        "plain_device_ms": main_gt["plain_device_ms"],
        "bound_ms": main_gt["bound_ms"],
        "bound_by": main_gt["bound_by"],
        "library_ms": None,
        "floor_device_ms": floor and floor["device_ms"],
        "wrapper_host_us_1xB": host_us,
        "shapes": shapes,
    }]}
    solve_line = {"solve": {
        "pods": N_PODS, "types": N_TYPES, "nodes": res.node_count(),
        "G": snap.G, "T": snap.T, "K": K, "W": W, "Gp": plan["Gp"],
        "Tp": plan["Tp"], "B": plan["B"], "Bp": Bp,
        "level_bits": plan["level_bits"],
        "bin_growths": stats.get("bin_growths", 0),
        "cold": {"wall_ms": cold_s * 1e3,
                 **{k: stats[k] for k in ("tensorize_ms", "solve_ms",
                                          "decode_ms")}},
        "warm": {"wall_ms": warm_s * 1e3,
                 **{k: warm[k] for k in ("tensorize_ms", "solve_ms",
                                         "decode_ms")}},
        "solve_step_gpu_ms": gpu_step_ms,
        "solve_step_cpu_ms": cpu_step_ms,
        "solve_step_trace": step_trace,
        "cpu_nodes": res_cpu.node_count(),
        "lp_floor": stats["floor"], "lp_led": stats["lp_led"],
        "lp_lb": float(lb), "lp_iters": floor_iters,
        "lp_floor_trace": floor_trace,
        "build_s": build_s,
    }}
    print(json.dumps(kernels_line))
    live_line["live_round"]["script_s"] = time.perf_counter() - t_script
    print(json.dumps(solve_line))
    print(json.dumps(live_line))
    print(json.dumps(cons_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
