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
   kernel of the path launched.
4. Holds each kernel against its plain PyTorch version on the card, at the
   main path's own inputs and at extra shapes (exact equality), and times
   kernel, plain version and bound: ``ms`` is the CUDA-event time per call
   of back-to-back wrapper calls (host launch cost included), ``device_ms``
   the kernels' own time from a torch.profiler trace.
5. Re-runs the dispatch with host reads forbidden (sync debug mode), then
   on the CPU plain path: assign, assign_e, used, tmpl, F, price must be
   bit-equal, and a CPU solve must open the same number of nodes.

Prints one ``{"kernels": [...]}`` line, one ``{"solve": ...}`` line, the
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


def _trace(fn, reps: int):
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
    launched = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        by_name[ev.key] = by_name.get(ev.key, 0.0) + us / reps
        launched += ev.count
    return by_name, launched, wall_us


def device_times(fn, reps: int, kernel: str | None = None) -> dict | None:
    """Device time per call from a torch.profiler trace of ``reps`` calls
    after a warm-up: total kernel time (or, with ``kernel``, the time of
    the kernels whose name holds it), kernels launched, the busy share of
    the traced wall time, and the largest kernel times by name. A trace
    can come back without the wanted kernel (seen once for the ctypes-
    launched compat kernel); it is taken again, up to three times, and
    None is reported if it never shows."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        by_name, launched, wall_us = _trace(fn, reps)
        mine = {k: v for k, v in by_name.items() if kernel is None or kernel in k}
        total_us = sum(by_name.values())
        if mine and sum(mine.values()) > 0:
            break
    else:
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"device_ms": sum(mine.values()) / 1e3,
            "wall_ms": wall_us / reps / 1e3,
            "kernels": launched / reps, "busy": total_us * reps / wall_us,
            "top_us": {k[:60]: v for k, v in top}}


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
    this data needs (2W+3 per group row and defined type key) at the
    vector rate; the larger of the two, and which one it is."""
    G, _, W = gm.shape
    T = tm.shape[0]
    in_bytes = sum(x.numel() * x.element_size() for x in (gm, gh, tm, th))
    in_bytes += gh.numel() + th.numel()  # the tol rows, one byte per key
    out_bytes = G * T
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops = G * int(th.sum()) * (2 * W + 3)
    ops_ms = ops / VECTOR_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.ops import cuda_kernels, kernels
    from karpenter_tpu_torch.ops.tensorize import kernel_args, tensorize
    from karpenter_tpu_torch.utils import resources as resutil
    from karpenter_tpu_torch.workload import build_workload

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
    check(launches["compat"] == 2 * n_dispatch,
          f"compat launches {launches['compat']} != 2 per dispatch")
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
    plan = TorchSolver.plan(snap)
    Bp = stats["bins"]
    args_np = kernel_args(snap, Gp=plan["Gp"], Tp=plan["Tp"])
    args_gpu = kernels.from_kernel_args(args_np, dev)
    args_cpu = kernels.from_kernel_args(args_np, "cpu")
    step_kw = dict(max_bins=Bp, with_existing=False,
                   level_bits=plan["level_bits"], max_minv=plan["max_minv"])

    # no host read inside the dispatch: sync debug mode raises on one
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out_gpu = kernels.solve_step(args_gpu, **step_kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_cpu = kernels.solve_step(args_cpu, **step_kw)
    cpu_step_s = time.perf_counter() - t0
    for key in ("assign", "assign_e", "used", "tmpl", "F", "price", "npods"):
        a, b = out_gpu[key].cpu().numpy(), out_cpu[key].numpy()
        check(a.shape == b.shape and np.array_equal(a, b),
              f"cuda and cpu solve_step differ in {key}")
    gpu_step_ms = time_ms(lambda: kernels.solve_step(args_gpu, **step_kw),
                          reps=5, inner=2)
    step_trace = device_times(lambda: kernels.solve_step(args_gpu, **step_kw), 3)

    cpu_solver = TorchSolver(device="cpu")
    pods3, templates3, its3 = build_workload(N_PODS, N_TYPES)
    res_cpu = cpu_solver.solve(pods3, templates3, its3)
    check(res_cpu.node_count() == res.node_count(),
          f"node count cuda {res.node_count()} != cpu {res_cpu.node_count()}")

    # ---- every kernel against its plain version, on the card ----
    _, K, W = args_gpu["g_mask"].shape
    gt_in = [args_gpu[k] for k in ("g_mask", "g_has", "g_tol",
                                   "t_mask", "t_has", "t_tol")]
    gm_in = gt_in[:3] + [args_gpu[k] for k in ("m_mask", "m_has", "m_tol")]
    rng = np.random.default_rng(0)
    cases = [("main GxT", gt_in), ("main GxM", gm_in)]
    for shape in [(8, 128, 128, 1), (1, 1, 1, 1), (7, 129, 5, 3),
                  (33, 1000, 17, 2), (100, 50, 3, 40), (9, 300, 64, 32)]:
        cases.append(("x".join(map(str, shape)), compat_case(rng, *shape, dev)))
    shapes = []
    mismatches = 0
    for label, inp in cases:
        got = cuda_kernels.compat(*inp)
        want = cuda_kernels.compat_reference(*inp)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        mismatches += bad
        entry = dict(case=label, shape=[inp[0].shape[0], inp[3].shape[0],
                                        inp[0].shape[1], inp[0].shape[2]],
                     mismatches=bad)
        if label.startswith("main"):
            bound, by = compat_bound_ms(inp[0], inp[1], inp[3], inp[4])
            kern = device_times(lambda: cuda_kernels.compat(*inp), 50,
                                kernel="compat_kernel")
            plain = device_times(
                lambda: cuda_kernels.compat_reference(*inp), 20)
            entry.update(
                ms=time_ms(lambda: cuda_kernels.compat(*inp)),
                plain_ms=time_ms(lambda: cuda_kernels.compat_reference(*inp),
                                 reps=10, inner=5),
                device_ms=kern and kern["device_ms"],
                plain_device_ms=plain and plain["device_ms"],
                plain_kernels=plain and plain["kernels"],
                bound_ms=bound, bound_by=by)
            entry["us"] = entry["ms"] * 1e3
        shapes.append(entry)
    check(mismatches == 0, f"compat kernel disagrees with its plain version "
                           f"in {mismatches} cells: {shapes}")
    main_gt = shapes[0]
    kernels_line = {"kernels": [{
        "name": "compat",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/compat.cu",
        "replaces": "karpenter_tpu/ops/pallas_kernels.py:62",
        "launches": launches["compat"],
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
        "solve_step_cpu_ms": cpu_step_s * 1e3,
        "solve_step_trace": step_trace,
        "cpu_nodes": res_cpu.node_count(),
        "build_s": build_s,
    }}
    print(json.dumps(kernels_line))
    print(json.dumps(solve_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
