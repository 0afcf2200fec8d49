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
   kernel of the path launched: compat twice per dispatch (G×T and G×M)
   and the pack kernel once (the whole group scan).
4. Holds each kernel against its plain PyTorch version on the card, at the
   main path's own inputs (compat: G×T, G×M, and the one group row × Bp
   bins that the plain pack loop launches; pack: the first dispatch of
   each benchmark cell's first batch, ``pack_cells``), at a scale case
   and at edge shapes (exact equality), and times kernel, plain version
   and bound: ``ms`` is the CUDA-event time per call of back-to-back
   wrapper calls (host launch cost included), ``device_ms`` the kernels'
   own time from a torch.profiler trace, ``floor_device_ms`` the device
   time of an empty launch, ``wrapper_host_us_1xB`` the host cost of one
   compat call at the 1×B shape beside its two fixed parts (the output
   allocation and a bare launch).
5. Re-runs the dispatch with host reads forbidden (sync debug mode), then
   on the CPU plain path: assign, assign_e, used, tmpl, types, tier,
   npods, F, price must be
   bit-equal, and a CPU solve must open the same number of nodes. Times
   the LP bin floor (``ops/relax.py``), which sizes the headline's bin
   axis on the card as the JAX package's does on an accelerator. Then the
   pack loop's multiply-add tie (``tie_check``: 400 pods of 200 cpu
   sizes, Gp 256, Tp 64, Bp 64): card = CPU bit for bit, and group row
   126's two pods on bin 5, none on bin 1, the jnp loop's decision.
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
   after (compat must launch twice and pack once per chunk wherever
   rows are dispatched); every row dispatch is re-run on the CPU plain path
   (bit-equal ``placed_g`` and ``used``) and every relax decision too
   (the same ship or fallback cause, selection and displacement); every
   answer is checked against the store in exact arithmetic (no survivor
   over its allocatable, every displaced pod placed, no pod on a
   retiree). A chunk of the ladder and the relax LP are traced, and the
   probe's own G×T and 1×(Np·Bp) products join the compat cases.
8. The operator loop, the fourth main path: ``workload.consolidation_env
   (2000)`` — 2,000 deployments of three 5-cpu/10-GiB replicas on one
   ``xl`` type, provisioned and bound through the port's ``Environment``
   with ``TorchSolver()``, then scaled to one replica — converged as
   ``perf/run.py``'s ``_converge_disruption`` does (``clock.step(20)``,
   ``run_until_idle``, until the node count holds for three rounds), with
   ``KARPENTER_RELAX=1`` (the card's default). Provisioning and every
   round are timed by stage (snapshot build/advance, probe dispatch,
   relax, confirming simulations, validation, live solves, drain,
   rebind, orchestration), every command is recorded, and the launch
   counts are zeroed before provisioning and before the convergence and
   read after each (compat must launch twice and pack once per solve and
   per probe chunk). The fleet must reach 667 nodes with all 2,000 pods
   bound, no node over its allocatable, at most one probe dispatch per
   cluster-state generation and no probe failure; the same build and
   convergence on the CPU plain path must ship the same commands and end
   the same; the run's last solve and probe dispatches are re-run on the
   CPU (bit-equal) and traced, and the last solve's products join the
   compat cases.
9. The admission plane, the fifth main path, on the card and on the CPU
   plain path: ``workload.priority_mix()`` (5,000 pods, three tiers) and
   ``gang_mix()`` (3,024 pods, 20 pod-groups) through
   ``AdmissionPlane.solve_round`` with ``TorchSolver()``, held against the
   port's tiered-FFD oracle, and ``preempt_env(8)`` with eight
   high-priority pods through ``Environment``, each run with the launch
   counts zeroed just before and read just after. priority-mix must
   fuse its three tiers into one dispatch and place all 5,000 pods in
   tier order within 2% of the oracle's nodes; gang-mix must pay 21
   dispatches, place 19 gangs atomically, route the starved one and bind
   no gang partly; preempt-mix must bind 8 of 8 after 8 confirmed
   preemptions and 16 evictions, every eviction from a confirmed,
   complete victim set, with the victims probed on the card. The card
   and the CPU give the same claims, errors, reports and evictions;
   compat launches 2 and pack 1 per solve step and probe chunk; each family's
   last dispatch (and the last probe) is re-run on the CPU, bit-equal;
   the fused dispatch is traced; its G×T and 1×Bp products, gang-mix's
   G×T and the probe's G×T and 1×(Np·Bp) join the compat cases.
10. The interruption path, the sixth main path: the spot storm of
   ``perf/run.py``'s ``run_spot`` (``workload.spot_storm``) on
   ``spot_env(100)`` — cut from 1,000 nodes, see ``SPOT_NODES`` — with
   ``ChaosCloud(random.Random(7))``, 6 of its 10 rounds (cut: see
   ``SPOT_STORM_CUT``), risk-aware (λ 2.0) on the card and again on the
   CPU plain path, risk-blind (λ 0) on the card, ``KARPENTER_RELAX=1``
   on all three. Each leg must give the JAX
   package's counts (notices, creates, proactive drains, degradations,
   end nodes, pods bound, end cost, no pod lost with lead) and the three
   gates must hold; the card's and the CPU's commands must be equal;
   the absorb probe must dispatch on the card; the leg's solver calls,
   per-solve wall and launches (compat 2 and pack 1 per solve step and
   probe chunk) are recorded; the last absorb row is re-run on the CPU and its
   G×T and 1×(Np·Bp) products join the compat cases. The storm's fleet
   is full, so its absorb rows answer False; a two-node fleet with room
   to spare (``absorb_slack``) then takes a notice on the card and on the
   CPU: its one absorb row must answer True and ship the delete-only
   drain with no replacement, every pod still bound, equal on both.

   Phases 3-10 run with ``KARPENTER_NATIVE_CUTOFF=0`` (set and restored
   around them): the engine ladder off, every solve and probe on the
   card, as their JAX numbers were taken.
11. The engine ladder and the entry point, the seventh main path, with
   routing at its default gates (``engines_phase``). The native engine
   (``karpenter_tpu_torch/native``, g++) must build. The crossover: the
   kernel arguments of five solves of the earlier phases — the storm's
   last solve, the operator's last confirm solve, gang-mix's last gang
   trial, priority-mix's fused dispatch and the headline — through
   the native engine, the card and the CPU plain path, each timed, with
   the engine the gates pick (the card for the headline and
   priority-mix, off the card for the other three); the card and the CPU
   bit-equal, the native engine's feasibility equal and its other
   outputs compared; then one probe chunk of up to 128 rows through
   ``solve_probe_batch``, the card and the CPU, ``placed_g`` and ``used``
   equal. The storm with the ladder: ``spot_storm(100)``, both legs on
   ``TorchSolver()`` with ``KARPENTER_RELAX=1``, the JAX package's counts
   and gates, every storm solve on the host loop or the native engine
   (34 + 2 and 1,015 + 191; with each leg's fleet build, the JAX
   package's 1,049 and 195), compat 2 and pack 1 launches per card-routed
   solve and probe chunk (none). The entry point:
   ``python -m karpenter_tpu_torch`` on a manifest of one v1 and one
   v1beta1 NodePool and 2,560 pods of 64 shapes, with
   ``KARPENTER_BATCH_IDLE_DURATION=0 KARPENTER_BATCH_MAX_DURATION=0`` and
   ``--tick 0.1 --max-ticks 40``: in process on the card (the batch must
   take it, compat 2 and pack 1 per card solve, every pod bound), in process
   with ``--device cpu`` (every solve native, the same nodes and bound
   pods), and as a program with ``--metrics`` (``/metrics`` scraped
   once, every pod bound).
12. The observability planes (``karpenter_tpu_torch/obs``), the obs
   phase, reusing the runs above; the tracer stays on throughout (its
   default) with ``KARPENTER_TRACE_DIR`` a temporary directory. At the
   headline: 25 interleaved pairs of solves with the tracer on and off
   after 6 untimed ones (each side's minimum must hold
   ``tests/test_obs.py``'s bound, on <= off x 1.02 + 20 ms), then one traced solve under torch.profiler with the LP
   floor off, whose ``solve.kernel`` spans must last at least the device
   time the profiler records (the span waits for the card). The operator
   loop's two runs (phase 8) each under a capture of the planes: the
   decision records, the timeline's events and the compile ledger's
   ``(family, key, cold)`` sequence must be equal on the card and on the
   CPU plain path; the provision and disrupt rounds' top spans by self
   time are printed; the longest disrupt round's leaf coverage must be at
   least 0.95; every Chrome dump must parse, and ``python -m
   karpenter_tpu_torch.obs report --timeline`` over the saved
   ``/introspect`` snapshot must exit 0. The entry point (phase 11): in
   process, the timeline must hold a launch and a registration for every
   node and a bind for each of the 2,560 pods, on the card as with
   ``--device cpu``; the program's ``/slo``, ``/introspect`` and
   ``/usage`` must answer 200 with JSON, ``/introspect``'s timeline
   counting the same launches, registrations and binds.

13. Replay capsules (``karpenter_tpu_torch/obs/capsule.py``), the capsule
   phase, with routing off as in phases 3-10 and ``KARPENTER_CAPSULE=1``
   (every recorded round writes its capsule): the headline solve as one
   traced round, ``consolidation_env(2000)`` built and given one
   disruption round (2,000 → 667 nodes), the single-node probe over the
   survivors, ``absorb_slack``'s notice and ``preempt_env(8)``'s
   preemption ladder. The runs must reach six seams — ``solver.invoke``,
   ``relax.dispatch``, ``global.dispatch``, ``probe.dispatch``,
   ``interruption.dispatch``, ``preempt.dispatch`` — and each must have
   a capsule (a seam whose capture a later one of the same round
   displaced is written from its last capture, and named so). Each
   seam's last capsule, and the headline's, replays ``exact`` on the
   card and on the CPU plain path; the headline capsule's A/B table
   (partitioned, replicated, device, native, host) is printed, and
   ``python -m karpenter_tpu_torch.obs replay`` runs as a program on it
   (``--ab``, on the card) and on the absorb capsule (``--device cpu``).
   One ``{"capsule": ...}`` line: capsules per seam, their bytes, the
   replay ms per rung, compat launches of the runs and the card replays.
   Each row seam's capsule arguments give two compat cases (its G×T and
   1×(Np·Bp) products) checked against the plain version and timed.
14. The solver service (``karpenter_tpu_torch/service``), the service
   phase, with routing off in the server and the oracles alike (at the
   defaults the tenants' 40-pod solves take the native engine, in
   process and in the server's fold): ``python -m karpenter_tpu_torch.
   service.solver_service`` started as its own process on the card
   (coalescing window 4 ms, ``KARPENTER_CAPSULE=1``); the headline
   through ``RemoteSolver`` (a CPU client) must equal the in-process
   ``TorchSolver()`` solve bit for bit in its arguments and outputs, 1,128
   nodes (``KARPENTER_RELAX=0`` on both: the client's plan runs no LP
   floor); then ``workload.run_multitenant`` — 8 tenants × 3 rounds × 40
   pods over one server in session mode — with every tenant's claims
   equal to its solo in-process oracle on the card, 8 full uploads, no
   resync, no remote fallback and the billing plane reconciled; then a
   burst of the 8 tenants' snapshots released together, which the window
   must fold. The server's capsules: every coalesced row replays
   ``exact`` on the card and on the CPU plain path, and so does the
   headline's; one batch of rows is timed on the card as one batched
   dispatch and as single dispatches (compat launches, device ms,
   kernels, wall; equal outputs). The server prints its compat launches
   at exit; they must cover its card dispatches. A batched row's G×T,
   G×M and 1×B compat products join the compat cases. One
   ``{"service": ...}`` line with the per-tenant p50/p99 from ``/slo``
   and the coalesce rate.

15. The mesh (``karpenter_tpu_torch/parallel/mesh.py``), the mesh phase:
   ``sharded_solve_host`` at the headline's kernel arguments over
   logical meshes of the one card (``logical_mesh``: ``cuda:0`` repeated,
   so each shard and block runs at a real mesh's shapes). The
   partitioned rung on 1×8 and on 2×4 must equal
   ``partitioned_reference`` bit for bit on the card and on the CPU plain
   path and place every pod (its used bins printed beside the unsharded
   solve's and the headline's 1,128 nodes, with the plan, the repaired
   pods and the overlap); the replicated rung on 2×4, under a nodepool
   limit the solve never reaches, and the unsharded rung on 1×1 must
   equal the unsharded ``solve_step`` on both; a 64-bin budget on 1×8
   under ``KARPENTER_SHARD_REPAIR_MAX=0`` must fall to the unsharded rung
   for the repair bound and equal ``solve_step`` at 64 bins. Each call
   records one ``mesh.partition`` decision and one ``mesh.solve``
   capture, whose capsule replays ``exact`` on the card and on the CPU;
   launches are counted per rung (compat 2 and pack 1 per shard, compat 2
   per replicated block and one pack, compat 2 and pack 1 unsharded) and
   its compat products at a shard's G×T,
   G×M and 1×budget and a replicated block's G×T join the compat cases.
   One ``{"mesh": ...}`` line.

16. The solve's dispatch path (``models/solver.py``), the dispatch
   phase, which runs right after phase 5 (late in a process that has
   profiled for minutes CUPTI drops records, and the phase counts
   compat's), with routing off: the headline (phase 3's batch, cloned) under
   ``KARPENTER_PROFILE_DIR`` must write one Chrome trace per dispatch
   holding CUDA kernel events, compat's symbol among them twice and the
   pack kernel's once per dispatch
   (taken again, up to three times, when the trace drops its records),
   with the claims of an unprofiled solve of the same batch; the walls
   with and without the profiler, the trace's size and its kernel events
   beside ``solve_step_trace``'s are printed. A one-pod-per-node burst of
   2,600 pods (``KARPENTER_RELAX=0``: the demand bound sizes the bin
   axis at 2,048, the solve doubles it once to 4,096) on one
   ``TorchSolver()``, three pairs of a cold solve (the doubled family
   forgotten first: the doubled dispatch is deferred) and a warm one (it
   speculates once, ``solve.dispatch_spec``), alternating which runs
   first; each grows once, launches compat 4 and pack 2 times and equals
   ``TorchSolver(device="cpu")``'s claims. An exact fit of 2,400 pods of
   5.2 cpu and 1,880 of 0.1 cpu on the same type, in as many pairs: its
   2,400-bin axis runs dry with no pod left over, so the warm solve's
   speculation at 4,096 is launched and thrown away (two dispatches)
   while the cold one dispatches once; both equal the CPU's claims.
   ``KARPENTER_DECODE_EXACT_SKIP`` at 0 and at 1 over the 96-pod selector
   mix and the headline: the card's ``decode.recheck`` verdicts, exact
   skips and claims equal the CPU plain path's. The compat products of
   the burst, the exact fit and the mix (G×T, G×M and a 1×Bp per bin axis
   they dispatch) join the compat cases. One ``{"dispatch": ...}`` line.

``python3 chip_smoke.py --full-storm [N]`` runs only the storm at
``perf/run.py``'s size (N 1,000) with the ladder on, round by round.

Prints one ``{"kernels": [...]}`` line, one ``{"solve": ...}`` line, one
``{"live_round": ...}`` line, one ``{"consolidation": ...}`` line, one
``{"operator": ...}`` line, one ``{"admission": ...}`` line, one
``{"spot": ...}`` line, one ``{"engines": ...}`` line, one ``{"obs": ...}``
line, one ``{"capsule": ...}`` line, one ``{"service": ...}`` line, one
``{"mesh": ...}`` line, one ``{"dispatch": ...}`` line, the card line, and
as its last line ``{"ok":
true, "device": {...}}``. Any
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
# the operator loop's fleet: perf/configs.py's config4_consolidation_env
# (2000), which the JAX package's perf/run.py _converge_disruption brings
# to 667 nodes (three 5-cpu pods to each 16-cpu node)
OPERATOR_NODES, OPERATOR_END_NODES = 2_000, 667
STEP_OUTPUTS = ("assign", "assign_e", "used", "tmpl", "F", "price", "npods",
                "types", "tier")

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


def pack_cells(kernels, cuda_kernels) -> list:
    """The pack kernel at each benchmark cell's shapes: the first dispatch
    of the cell's first batch (``portbench``'s generator and program, on
    the card), its pack inputs rebuilt from the dispatch's kernel
    arguments. Per cell: the kernel's time per call by CUDA events (host
    launch included) and its device time from a trace, its cluster, the
    bytes bound (each input byte read once and each output byte written
    once at HBM rate: the kernel is bound by the latency of its G
    sequential steps, so this bound is far below it), and the plain loop
    (``pack_reference``) on the same CUDA tensors, one call, wall time —
    which must give the same outputs bit for bit."""
    import torch

    from portbench import gen, system
    from portbench.spec import Spec

    spec = Spec()
    out = []
    for name in ("burst-50k", "diverse-500", "generic-500"):
        cell = spec.cell(name)
        cfg, traffic = spec.config(cell), spec.traffic(cell)
        program = system.Program(cfg, gen.catalog(cfg), traffic["topology"])
        seen = []
        step = kernels.solve_step
        kernels.solve_step = lambda args, **kw: (  # noqa: E731
            seen.append((args, kw)) or step(args, **kw))
        try:
            program.decide(program.batch(gen.batch(traffic, 1)))
        finally:
            kernels.solve_step = step
        check(seen, f"pack {name}: the first batch made no device dispatch")
        args, kw = seen[0]
        a = kernels._with_defaults(args)
        F, _, tmpl_full = kernels._feasibility(a)
        B, T = kw["max_bins"], a["t_alloc"].shape[0]
        pk = dict(max_bins=B, with_existing="e_avail" in args,
                  level_bits=kw["level_bits"], max_minv=kw["max_minv"],
                  fma_cap=B == T, fma_rem=kw.get("fma_rem", True))
        inputs = (a["g_count"][None], a["e_avail"][None])

        def kernel():
            return kernels._pack(a, F, tmpl_full, *inputs, **pk)

        def plain():
            # the plain loop on the same CUDA tensors: _pack's route swapped
            route = kernels.pack
            kernels.pack = kernels.pack_reference
            try:
                return kernels._pack(a, F, tmpl_full, *inputs, **pk)
            finally:
                kernels.pack = route

        got = kernel()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for key in got:
            check(torch.equal(got[key], want[key]),
                  f"pack {name}: the kernel and the plain loop differ in "
                  f"{key} on the card")
        names = ("g_demand", "g_mask", "g_has", "g_bin_cap", "g_single",
                 "g_decl", "g_match", "g_sown", "g_smatch", "g_aneed",
                 "g_amatch", "g_tier", "ge_ok", "e_npods", "e_scnt",
                 "e_decl", "e_match", "e_aff", "t_alloc", "t_cap", "t_tmpl",
                 "m_mask", "m_has", "m_overhead", "m_limits", "m_minv")
        in_bytes = sum(a[k].numel() * a[k].element_size() for k in names)
        in_bytes += sum(x.numel() * x.element_size()
                        for x in (F, tmpl_full, *inputs))
        out_bytes = sum(x.numel() * x.element_size() for x in got.values())
        trace = device_times(kernel, 3, kernel="pack_kernel")
        G = int(a["g_demand"].shape[0])
        out.append({
            "cell": name, "G": G, "B": B, "T": T,
            "R": int(a["g_demand"].shape[1]), "E": int(a["e_avail"].shape[0]),
            "level_bits": pk["level_bits"],
            "cluster": cuda_kernels.pack_cluster(1, B, T),
            "ms": time_ms(kernel, reps=5, inner=2),
            "device_ms": trace and trace["device_ms"],
            "device_us_per_group": trace and trace["device_ms"] * 1e3 / G,
            "bound_ms": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "plain_ms": plain_ms})
    return out


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


def capsule_cases(label, cap, kernels) -> list:
    """The compat products a capsule's dispatch runs, from its kernel
    arguments uploaded to the card: a solve (``solver.invoke``,
    ``service.solve``) G×T, G×M and 1×B; a counterfactual-row seam G×T and
    1×(Np·Bp), Np the rows padded as the dispatch pads them."""
    import torch

    from karpenter_tpu_torch.ops import consolidate as cons

    a = kernels.from_kernel_args(cap.args(), torch.device("cuda"))
    gt = [a[k] for k in ("g_mask", "g_has", "g_tol",
                         "t_mask", "t_has", "t_tol")]
    mb = int(cap.static("max_bins", 1))
    if cap.seam in ("solver.invoke", "service.solve"):
        G = int((np.asarray(cap.args()["g_count"]) > 0).sum())
        gm = gt[:3] + [a[k] for k in ("m_mask", "m_has", "m_tol")]
        return [(f"{label} GxT", gt), (f"{label} GxM", gm),
                (f"{label} 1xB", bins_case(a, G, mb, kernels))]
    rows = np.asarray(cap.sidecar("g_count_rows"))
    G = int((rows > 0).any(axis=0).sum())
    Np = cons._pow2(int(rows.shape[0]), lo=4)
    return [(f"{label} GxT", gt),
            (f"{label} 1xNpB", bins_case(a, G, Np * mb, kernels))]


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


def tie_check(kernels) -> dict:
    """The pack loop's multiply-add tie: 400 pods of 200 cpu sizes (``0.1 +
    (i % 200) · 0.01`` cpu, 1 GiB) on one pool over ``benchmark_catalog
    (64)``, the LP floor off (Gp 256, Tp 64, Bp 64). Bin 1 holds 63.07 of
    63.9 cpu when group row 126 (0.83 cpu, 2 pods) is packed: its capacity
    is 1.0 op by op and 0.9999989 in one rounding, as the JAX package's
    compiled loop computes it. On the card (the pack kernel, which rounds
    the capacity formula once at this shape) as on the CPU plain path
    (bit-equal), both pods must land on bin 5 and none on bin 1 — the jnp
    loop's decision (``tests/test_torch_kernels.py``
    ``test_multiply_add_tie_bit_equal``)."""
    from karpenter_tpu_torch.api.nodepool import NodePool
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_tpu_torch.cloudprovider.catalog import benchmark_catalog
    from karpenter_tpu_torch.models import ClaimTemplate, TorchSolver
    from karpenter_tpu_torch.ops.tensorize import kernel_args, tensorize

    pods = [Pod(metadata=ObjectMeta(name=f"p{i}"),
                requests={"cpu": 0.1 + (i % 200) * 0.01, "memory": 2**30})
            for i in range(400)]
    pool = NodePool(metadata=ObjectMeta(name="default"))
    with env_knobs(KARPENTER_RELAX="0"):
        snap = tensorize(pods, [ClaimTemplate(pool)],
                         {"default": benchmark_catalog(64)})
        plan = TorchSolver(device="cpu").plan(snap)
    check((plan["Gp"], plan["Tp"], plan["Bp"]) == (256, 64, 64),
          f"tie: the shape is {plan}")
    args = kernels.from_kernel_args(
        kernel_args(snap, Gp=plan["Gp"], Tp=plan["Tp"]), "cuda")
    step_kw = dict(max_bins=plan["Bp"], level_bits=plan["level_bits"],
                   max_minv=plan["max_minv"])
    gpu_ms, cpu_ms = check_dispatch(args, step_kw, kernels, "tie")
    from karpenter_tpu_torch.ops import cuda_kernels

    before = cuda_kernels.LAUNCHES["pack"]
    row = kernels.solve_step(args, **step_kw)["assign"][126].cpu().numpy()
    check(cuda_kernels.LAUNCHES["pack"] == before + 1,
          "tie: the card's solve did not go through the pack kernel")
    check(int(row[1]) == 0 and int(row[5]) == 2,
          f"tie: group row 126 lands {row[:8].tolist()}, want both pods on "
          "bin 5 and none on bin 1")
    return {"Gp": plan["Gp"], "Tp": plan["Tp"], "Bp": plan["Bp"],
            "row_126": row[:8].tolist(), "gpu_ms": gpu_ms, "cpu_ms": cpu_ms}


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
    check(launches["compat"] == 2 * len(dispatches)
          and launches["pack"] == len(dispatches),
          f"live round: launches {launches} != compat 2 and pack 1 per "
          f"dispatch over {len(dispatches)} dispatches")
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

    def recording_lp(t, max_iters, tol, rho, **kw):
        if t["d"].is_cuda:  # not the CPU re-run's
            lps.append((t, max_iters, tol, rho))
        return real_lp(t, max_iters, tol, rho, **kw)

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
            check(launches["compat"] == 2 * chunks
                  and launches["pack"] == chunks,
                  f"{label}: launches {launches} != compat 2 and pack 1 "
                  f"× {chunks} chunks")
        else:
            check(launches["compat"] == launches["pack"] == 0,
                  f"{label}: a kernel launched with no rows dispatched")
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


def _owner(pod) -> str:
    refs = pod.metadata.owner_references
    return refs[0]["name"] if refs else pod.metadata.name


def _fleet_state(env) -> tuple:
    """The fleet as (instance type, pool, capacity type, zone, its pods by
    owner) per live node, sorted, and the unbound pods by owner."""
    from karpenter_tpu_torch.api import labels as wk

    pods_on: dict = {}
    unbound = []
    for p in env.store.list("pods"):
        if p.metadata.deletion_timestamp is not None:
            continue
        if p.node_name:
            pods_on.setdefault(p.node_name, []).append(_owner(p))
        else:
            unbound.append(_owner(p))
    nodes = sorted(
        (n.labels.get(wk.INSTANCE_TYPE_LABEL, ""),
         n.labels.get(wk.NODEPOOL_LABEL, ""),
         n.labels.get(wk.CAPACITY_TYPE_LABEL, ""),
         n.labels.get(wk.TOPOLOGY_ZONE_LABEL, ""),
         tuple(sorted(pods_on.get(n.name, ()))))
        for n in env.store.list("nodes")
        if n.metadata.deletion_timestamp is None)
    return nodes, sorted(unbound)


def operator_loop(device, kernels, cuda_kernels) -> dict:
    """``workload.consolidation_env(OPERATOR_NODES)`` built through the
    port's ``Environment`` with ``TorchSolver(device)`` (None: the card),
    then converged as ``perf/run.py``'s ``_converge_disruption`` does.
    Returns the record: provisioning and per-round stage times, launch
    counts, every command, the end state, and the last solve and probe
    dispatch of the run (their inputs, for the checks)."""
    import torch

    from karpenter_tpu_torch.controllers.disruption import controller as dctl
    from karpenter_tpu_torch.controllers.disruption import methods
    from karpenter_tpu_torch.controllers.disruption import queue as oq
    from karpenter_tpu_torch.controllers.node import termination
    from karpenter_tpu_torch.controllers.provisioning.provisioner import (
        Provisioner,
    )
    from karpenter_tpu_torch.kube import binder
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.operator import metrics as m
    from karpenter_tpu_torch.ops import consolidate as cons
    from karpenter_tpu_torch.utils import resources as resutil
    from karpenter_tpu_torch.workload import consolidation_env

    on_card = device is None
    acc = dict(solves=0, solve_ms=0.0, live_batches=0,
               live_ms=0.0, probe_dispatches=0, probe_rows=0,
               probe_chunks=0, dispatch_ms=0.0,
               build=0, build_ms=0.0, advance=0, advance_ms=0.0,
               confirms=0, confirm_ms=0.0, validations=0, validate_ms=0.0)
    last: dict = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(key_n, key_ms, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        acc[key_n] += 1
        acc[key_ms] += (time.perf_counter() - t0) * 1e3
        return out

    real = dict(
        step=kernels.solve_step, dispatch=cons.dispatch_counterfactual_rows,
        build=cons.build_disruption_snapshot,
        advance=cons.DisruptionSnapshot.advance,
        confirm=methods.compute_consolidation,
        validate=dctl.simulate_scheduling, schedule=Provisioner.schedule)

    def step(args, **kw):
        last["solve"] = (args, kw)
        return timed("solves", "solve_ms", real["step"], args, **kw)

    def dispatch(shared, Gp, Ep, e_avail, max_minv, g_count_k, e_zero_cols,
                 e_free=None, max_bins=1):
        out = timed("probe_dispatches", "dispatch_ms", real["dispatch"],
                    shared, Gp, Ep, e_avail, max_minv, g_count_k,
                    e_zero_cols, e_free=e_free, max_bins=max_bins)
        rows = g_count_k.shape[0]
        chunks = -(-rows // cons.PROBE_CHUNK_ROWS)
        acc["probe_rows"] += rows
        acc["probe_chunks"] += chunks
        last["probe"] = dict(args=(shared, Gp, Ep, e_avail, max_minv,
                                   g_count_k, e_zero_cols),
                             max_bins=max_bins, out=out)
        return out

    def schedule(self, pods=None, **kw):
        if pods is not None:  # a disruption simulation: timed as confirm
            return real["schedule"](self, pods=pods, **kw)
        return timed("live_batches", "live_ms", real["schedule"], self,
                     **kw)

    kernels.solve_step = step
    cons.dispatch_counterfactual_rows = dispatch
    cons.build_disruption_snapshot = (
        lambda *a, **kw: timed("build", "build_ms", real["build"], *a, **kw))
    cons.DisruptionSnapshot.advance = (
        lambda self, *a, **kw: timed("advance", "advance_ms",
                                     real["advance"], self, *a, **kw))
    methods.compute_consolidation = (
        lambda *a, **kw: timed("confirms", "confirm_ms", real["confirm"],
                               *a, **kw))
    dctl.simulate_scheduling = (
        lambda *a, **kw: timed("validations", "validate_ms",
                               real["validate"], *a, **kw))
    Provisioner.schedule = schedule
    stats0 = {k: dict(s) for k, s in (
        ("drain", termination.STATS), ("bind", binder.STATS),
        ("orchestrate", oq.STATS))}
    binder.WAVE_HINTS.clear()
    try:
        # ---- provisioning: the fleet through the loop ----
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        env = consolidation_env(OPERATOR_NODES, solver=TorchSolver(device))
        sync()
        build_ms = (time.perf_counter() - t0) * 1e3
        prov_launches = dict(cuda_kernels.LAUNCHES)
        check(env.provisioner.solver.device.type
              == ("cuda" if on_card else "cpu"), "operator: solver device")
        provisioning = dict(
            wall_ms=build_ms, start_nodes=len(env.store.list("nodes")),
            **{k: acc[k] for k in ("live_batches", "live_ms", "solves",
                                   "solve_ms")},
            bind_ms=binder.STATS["rebind_ms"] - stats0["bind"]["rebind_ms"],
            bound=binder.STATS["bound"] - stats0["bind"]["bound"],
            compat_launches=prov_launches["compat"],
            compat_expected=2 * acc["solves"],
            pack_launches=prov_launches["pack"], pack_expected=acc["solves"])
        start = _fleet_state(env)

        # ---- disruption: converge as perf/run.py does ----
        commands: list = []
        # the stage times of each disruption round that shipped a command:
        # from the previous command (or the start) to this one's execution
        command_stages: list = []
        mark: dict = {}
        ordinal: dict = {}
        real_execute = env.disruption._execute

        def stage_delta():
            now = dict(acc, relax_ms=cons.GLOBAL_STATS["relax_ms"],
                       t=time.perf_counter())
            d = {k: now[k] - mark.get(k, now[k]) for k in now}
            mark.clear()
            mark.update(now)
            d["wall_ms"] = d.pop("t") * 1e3
            return d

        def execute(cmd, method=None):
            command_stages.append(stage_delta())
            for name in sorted((nc.name for nc in env.store.list(
                    "nodeclaims") if nc.name not in ordinal),
                    key=lambda s: int(s.rsplit("-", 1)[-1])):
                ordinal[name] = len(ordinal)
            commands.append((
                type(method).__name__, method_rung(method), cmd.action,
                [ordinal.get(c.name, -1) for c in cmd.candidates],
                [sorted(it.name for it in claim.instance_types)
                 for claim in cmd.replacements]))
            return real_execute(cmd, method)

        env.disruption._execute = execute
        gmethod = next(mt for mt in env.disruption.methods
                       if isinstance(mt, methods.GlobalConsolidation))
        cons.reset_dispatch_log()
        for k in acc:
            acc[k] = 0 if isinstance(acc[k], int) else 0.0
        cuda_kernels.reset_launches()
        rounds: list = []
        # the ladders' verdicts over the convergence, off the decision
        # ledger: (site, rung, reason)
        from karpenter_tpu_torch.obs import decisions

        counts0 = decisions.counts()
        stage_delta()
        t_conv = time.perf_counter()
        stable = 0
        while len(rounds) < 100 and stable < 3:
            before_nodes = len(env.store.list("nodes"))
            snap0 = dict(acc)
            st0 = {k: dict(s) for k, s in (
                ("drain", termination.STATS), ("bind", binder.STATS),
                ("orchestrate", oq.STATS))}
            relax0 = cons.GLOBAL_STATS["relax_ms"]
            n_cmd = len(commands)
            gens0 = dict(cons.DISPATCHES_BY_GEN)
            t0 = time.perf_counter()
            env.clock.step(20.0)
            env.run_until_idle(max_rounds=500)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
            d = {k: acc[k] - snap0[k] for k in acc}
            rounds.append(dict(
                wall_ms=wall, nodes=len(env.store.list("nodes")),
                commands=commands[n_cmd:],
                global_rung=(f"{gmethod.last_rung}/"
                             f"{last_reason('consolidate.global')}"),
                snapshot=dict(builds=d["build"], build_ms=d["build_ms"],
                              advances=d["advance"],
                              advance_ms=d["advance_ms"]),
                probe=dict(dispatches=d["probe_dispatches"],
                           rows=d["probe_rows"], chunks=d["probe_chunks"],
                           ms=d["dispatch_ms"],
                           by_generation={
                               str(g): n - gens0.get(g, 0)
                               for g, n in cons.DISPATCHES_BY_GEN.items()
                               if n != gens0.get(g, 0)}),
                relax_ms=cons.GLOBAL_STATS["relax_ms"] - relax0,
                confirms=d["confirms"], confirm_ms=d["confirm_ms"],
                validations=d["validations"], validate_ms=d["validate_ms"],
                solves=d["solves"], solve_ms=d["solve_ms"],
                live_batches=d["live_batches"], live_ms=d["live_ms"],
                drain_ms=termination.STATS["drain_ms"]
                - st0["drain"]["drain_ms"],
                rebind_ms=binder.STATS["rebind_ms"]
                - st0["bind"]["rebind_ms"],
                orchestrate_ms=oq.STATS["orchestrate_ms"]
                - st0["orchestrate"]["orchestrate_ms"]))
            stable = stable + 1 if rounds[-1]["nodes"] == before_nodes else 0
        converge_ms = (time.perf_counter() - t_conv) * 1e3
        conv_launches = dict(cuda_kernels.LAUNCHES)
        end = _fleet_state(env)
        # every survivor within its allocatable
        used: dict = {}
        for p in env.store.list("pods"):
            if p.node_name and p.metadata.deletion_timestamp is None:
                used[p.node_name] = resutil.merge(
                    used.get(p.node_name, {}), p.effective_requests())
        over = [n.name for n in env.store.list("nodes")
                if not resutil.fits(used.get(n.name, {}), n.allocatable)]
        failures = env.registry.counter(m.DISRUPTION_PROBE_FAILURES).total()
        verdicts = {k for k, n in decisions.counts().items()
                    if k[0] in ("consolidate.global", "probe.confirm")
                    and n > counts0.get(k, 0)}
        rec = dict(
            provisioning=provisioning, start=start, end=end,
            commands=commands, command_stages=command_stages,
            rounds=rounds, converge_ms=converge_ms,
            verdicts=sorted(verdicts), over_allocatable=over,
            probe_failures=failures,
            max_dispatches_per_generation=(
                cons.max_dispatches_per_generation()),
            generations_dispatched=len(cons.DISPATCHES_BY_GEN),
            compat_launches=conv_launches["compat"],
            compat_expected=2 * (acc["solves"] + acc["probe_chunks"]),
            pack_launches=conv_launches["pack"],
            pack_expected=acc["solves"] + acc["probe_chunks"],
            totals={k: acc[k] for k in acc},
            drain_ms=termination.STATS["drain_ms"]
            - stats0["drain"]["drain_ms"],
            rebind_ms=binder.STATS["rebind_ms"] - stats0["bind"]["rebind_ms"],
            last=dict(last))
        del env
        return rec
    finally:
        kernels.solve_step = real["step"]
        cons.dispatch_counterfactual_rows = real["dispatch"]
        cons.build_disruption_snapshot = real["build"]
        cons.DisruptionSnapshot.advance = real["advance"]
        methods.compute_consolidation = real["confirm"]
        dctl.simulate_scheduling = real["validate"]
        Provisioner.schedule = real["schedule"]


def operator_phase(cuda_kernels, kernels) -> tuple:
    """The operator loop on the card and on the CPU plain path:
    ``(line, launches, cases)`` — the printed record, the compat launches
    of the card's run, and its last dispatch's compat products."""
    import torch

    from karpenter_tpu_torch.ops import consolidate as cons

    # the relax rung's default on the card (on) for both paths, so the
    # CPU plain path takes the same rungs
    with env_knobs(KARPENTER_RELAX="1"):
        t0 = time.perf_counter()
        with ObsCapture() as card_obs:
            card = operator_loop(None, kernels, cuda_kernels)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with ObsCapture() as cpu_obs:
            cpu = operator_loop("cpu", kernels, cuda_kernels)
        cpu_s = time.perf_counter() - t0
    OBS["operator"] = (card_obs, cpu_obs)

    nodes, unbound = card["end"]
    bound = sum(len(n[4]) for n in nodes)
    check(len(nodes) == OPERATOR_END_NODES and bound == OPERATOR_NODES
          and not unbound,
          f"operator: converged to {len(nodes)} nodes with {bound} pods "
          f"bound and {len(unbound)} unbound, want {OPERATOR_END_NODES} "
          f"nodes and {OPERATOR_NODES} pods bound")
    check(not card["over_allocatable"],
          f"operator: nodes over their allocatable: "
          f"{card['over_allocatable'][:5]}")
    check(card["max_dispatches_per_generation"] <= 1,
          f"operator: {card['max_dispatches_per_generation']} probe "
          "dispatches in one cluster-state generation")
    check(card["probe_failures"] == 0,
          f"operator: {card['probe_failures']} probe failures")
    bad = [v for v in card["verdicts"] + cpu["verdicts"]
           if v[1] == "sequential" and v[2] in ("probe-error", "no-device")]
    check(not bad, f"operator: a round fell back without the card: {bad}")
    for label in ("provisioning", None):
        got = card[label] if label else card
        check(got["compat_launches"] > 0,
              f"operator {label or 'disruption'}: compat never launched")
        check(got["compat_launches"] == got["compat_expected"]
              and got["pack_launches"] == got["pack_expected"],
              f"operator {label or 'disruption'}: launches compat "
              f"{got['compat_launches']} and pack {got['pack_launches']} "
              f"!= 2 and 1 per dispatch ({got['compat_expected']}, "
              f"{got['pack_expected']})")
    check(card["totals"]["probe_dispatches"] > 0,
          "operator: no probe dispatch ran")
    check(card["start"] == cpu["start"],
          "operator: the card and the CPU built different fleets")
    check(card["commands"] == cpu["commands"],
          f"operator: the card's commands {card['commands']} differ from "
          f"the CPU plain path's {cpu['commands']}")
    check(card["end"] == cpu["end"] and len(card["rounds"])
          == len(cpu["rounds"]),
          "operator: the card and the CPU plain path end differently")

    # the run's last dispatches, again: on the card and on the CPU
    HANDOFF["operator confirm"] = card["last"]["solve"]
    HANDOFF["probe chunk"] = card["last"]["probe"]
    args_gpu, step_kw = card["last"]["solve"]
    solve_gpu_ms, solve_cpu_ms = check_dispatch(args_gpu, step_kw, kernels,
                                                "operator solve")
    probe = card["last"]["probe"]
    shared, Gp, Ep, e_avail, mm, gk, cols = probe["args"]
    t0 = time.perf_counter()
    want = cons.dispatch_counterfactual_rows(
        {k: v.cpu() for k, v in shared.items()}, Gp, Ep, e_avail, mm, gk,
        cols, max_bins=probe["max_bins"])
    probe_cpu_ms = (time.perf_counter() - t0) * 1e3
    for a, b in zip(probe["out"], want):
        check(a.shape == b.shape and np.array_equal(a, b),
              "operator: the last probe dispatch differs on the CPU")
    # both under the profiler: kernels, device time, busy share
    e_master = torch.zeros((Ep, e_avail.shape[1]), device="cuda")
    e_master[:e_avail.shape[0]] = torch.from_numpy(
        np.asarray(e_avail, np.float32)).cuda()
    varying = cons.chunk_rows(e_master, gk, cols, None, 0,
                              min(cons.PROBE_CHUNK_ROWS, len(gk)), Gp)
    traces = {
        "solve_step": device_times(
            lambda: kernels.solve_step(args_gpu, **step_kw), 3),
        "probe_chunk": device_times(
            lambda: kernels.probe_step(varying, shared, probe["max_bins"],
                                       mm), 3),
    }
    cases = [("operator GxT", [args_gpu[k] for k in (
                 "g_mask", "g_has", "g_tol", "t_mask", "t_has", "t_tol")]),
             ("operator 1xB", bins_case(args_gpu, int(
                 args_gpu["g_demand"].shape[0]), step_kw["max_bins"],
                 kernels))]

    def summary(rec, seconds):
        return dict(
            seconds=seconds, provisioning=rec["provisioning"],
            converge_ms=rec["converge_ms"], rounds=rec["rounds"],
            command_stages=rec["command_stages"],
            end_nodes=len(rec["end"][0]),
            pods_bound=sum(len(n[4]) for n in rec["end"][0]),
            drain_ms=rec["drain_ms"], rebind_ms=rec["rebind_ms"],
            totals=rec["totals"])

    def brief(cmd):
        method, rung, action, cands, repl = cmd
        return [method, rung, action, len(cands),
                cands if len(cands) <= 6 else cands[:3] + ["..."]
                + cands[-3:], repl]

    line = {"operator": {
        "nodes": OPERATOR_NODES, "end_nodes": len(nodes), "pods_bound": bound,
        "commands": [brief(c) for c in card["commands"]],
        "verdicts": card["verdicts"],
        "max_dispatches_per_generation":
            card["max_dispatches_per_generation"],
        "generations_dispatched": card["generations_dispatched"],
        "probe_failures": card["probe_failures"],
        "compat_launches": {"provisioning":
                            card["provisioning"]["compat_launches"],
                            "disruption": card["compat_launches"]},
        "card": summary(card, card_s), "cpu": summary(cpu, cpu_s),
        "last_solve": {"gpu_ms": solve_gpu_ms, "cpu_ms": solve_cpu_ms,
                       "Gp": int(args_gpu["g_demand"].shape[0]),
                       "Bp": step_kw["max_bins"]},
        "last_probe": {"rows": int(gk.shape[0]), "Gp": Gp, "Ep": Ep,
                       "cpu_ms": probe_cpu_ms},
        "traces": traces,
    }}
    launches = {k: card["provisioning"][f"{k}_launches"]
                + card[f"{k}_launches"] for k in ("compat", "pack")}
    return line, launches, cases


# the admission grid and the spot storm (perf/run.py run_priority and
# run_spot), with the decisions the JAX package reaches on them
PRIORITY_EXPECT = dict(tiers=3, solve_dispatches=1, fused_runs=1,
                       scheduled=5000)
GANG_EXPECT = dict(tiers=2, solve_dispatches=21, gangs_placed=19,
                   gangs_routed=1, partial=0)
PREEMPT_NODES = 8
PREEMPT_EXPECT = dict(hi_bound=8, confirmed=8, declined=0, evictions=16)
# the storm's fleet is cut from perf/run.py's 1,000 nodes: the storm's
# solver calls grow with the fleet (1,244 at 100 nodes), and at 1,000
# nodes each costs the host ~0.14 s with the ladder on (the host loop
# walks every existing node), so one leg alone outlasts the run
# (``--full-storm`` runs it)
SPOT_NODES, SPOT_NODES_FULL = 100, 1000
SPOT_STORM = dict(rounds=10, rate=0.25, step=30.0, seed=7, shift=1.25)
# the spot phase runs the storm cut to 6 of its 10 rounds, every leg
# pinned to the card: the risk-blind leg's 1,206 small solves took
# 158-274 s of launch-bound wall there at 10 rounds, which left the whole
# script 1,077 s on a slow host against its 1,200 s limit. 6 rounds keep
# every storm event (the no-lead notice at round 4, price shifts at rounds
# 2, 4 and 6) and the three gates; at 4 rounds the blind fleet ends the
# cheaper (31.25 against 38.0) and the cost gate has nothing to hold. The
# engines phase's storm with the ladder runs all 10 rounds.
SPOT_STORM_CUT = dict(SPOT_STORM, rounds=6)
SPOT_CUT = ("the spot phase's storm at 6 of its 10 rounds (pinned to the "
            "card, the risk-blind leg's 1,206 small solves took 158-274 s "
            "at 10); the engines phase runs all 10 with the ladder")
# the JAX package's counts at 6 rounds (``PERF_SPOT_NODES=100
# PERF_SPOT_ROUNDS=6 KARPENTER_RELAX=1 python perf/run.py spot``)
SPOT_EXPECT_CUT = {
    "risk_aware": dict(lam=2.0, notices=5, creates=5, proactive_drains=4,
                       deadline_degradations=1, end_nodes=100,
                       pods_bound=300, end_cost=38.0, pods_lost_with_lead=0),
    "risk_blind": dict(lam=0.0, notices=142, creates=141,
                       proactive_drains=141, deadline_degradations=1,
                       end_nodes=100, pods_bound=300, end_cost=38.839375,
                       pods_lost_with_lead=0),
}
# ... and at all 10 (``PERF_SPOT_ROUNDS=10``)
SPOT_EXPECT = {
    "risk_aware": dict(lam=2.0, notices=11, creates=10, proactive_drains=9,
                       deadline_degradations=2, end_nodes=100,
                       pods_bound=300, end_cost=38.0, pods_lost_with_lead=0),
    "risk_blind": dict(lam=0.0, notices=190, creates=188,
                       proactive_drains=188, deadline_degradations=2,
                       end_nodes=100, pods_bound=300, end_cost=40.994563,
                       pods_lost_with_lead=0),
}


def method_rung(method) -> str:
    """A command's rung as the tests' ``CommandLog`` writes it: the
    method's ladder rung with the reason of its site's last verdict on the
    decision ledger, else the kind of its probe."""
    from karpenter_tpu_torch.obs import decisions

    site = getattr(method, "decision_site", "")
    if site and getattr(method, "last_rung", ""):
        last = decisions.DECISIONS.site_summary().get(site, {}).get(
            "last", {})
        return f"{method.last_rung}/{last.get('reason', '')}"
    return getattr(method, "last_probe", "")


def last_reason(site: str) -> str:
    """The reason of ``site``'s last verdict on the decision ledger."""
    from karpenter_tpu_torch.obs import decisions

    return decisions.DECISIONS.site_summary().get(site, {}).get(
        "last", {}).get("reason", "")


class ObsCapture:
    """The port's observability planes over one run: the planes reset and
    the tracer on (its ring sized to keep every round) on entry, the
    decision records ``(site, rung, reason)`` and the compile ledger's
    ``(family, key, cold)`` in order while it runs, and on exit the kept
    rounds, the timeline's events (times and trace ids dropped, generated
    names numbered by first appearance), the padding counts and the
    ``/introspect`` snapshot."""

    RING = 1_000_000

    def __enter__(self):
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.obs import decisions, devplane, timeline

        self.planes = obs, decisions, devplane, timeline
        # the timeline's ring holds every event of the run
        self.knobs = env_knobs(KARPENTER_TIMELINE_RING=str(self.RING))
        self.knobs.__enter__()
        obs.reset()
        obs.configure(enabled=True, capacity=self.RING)
        devplane.reset()
        timeline.reset()
        self.decisions, self.ledger = [], []
        record = decisions.DECISIONS.record
        dispatch = devplane.LEDGER.record_dispatch

        def spy_record(site, rung, reason="ok", **kw):
            got = record(site, rung, reason, **kw)
            self.decisions.append((site, rung, got))
            return got

        def spy_dispatch(family, key, seconds, **kw):
            cold = dispatch(family, key, seconds, **kw)
            self.ledger.append((family, repr(key), cold))
            return cold

        decisions.DECISIONS.record = spy_record
        devplane.LEDGER.record_dispatch = spy_dispatch
        return self

    def __exit__(self, *exc):
        obs, decisions, devplane, timeline = self.planes
        del decisions.DECISIONS.record
        del devplane.LEDGER.record_dispatch
        self.traces = obs.RECORDER.traces()
        seen: dict = {}

        def name(field, value):
            table = seen.setdefault(field, {})
            return table.setdefault(value, len(table))

        self.events = []
        for ev in timeline.timeline_snapshot(k=self.RING)["events"]:
            row = []
            for k, v in sorted(ev.items()):
                if k in ("at", "trace_id"):
                    continue
                if k in ("node", "claim"):
                    v = name("node", v)
                elif k == "pod":
                    v = name("pod", v)
                elif k == "cause" and v:
                    v = sorted(v.items())
                row.append((k, v))
            self.events.append(row)
        self.stats = {k: devplane.STATS[k] for k in (
            "cold_compiles", "warm_dispatches", "pad_dispatches",
            "pad_cells_actual", "pad_cells_padded", "bin_growths")}
        self.introspect = decisions.introspect_snapshot(k=64)
        self.knobs.__exit__(None, None, None)
        obs.reset()
        return False

    def top_self_ms(self, round_name: str, top: int = 8) -> list:
        """The spans with the most self time over every kept round of
        ``round_name``."""
        agg: dict = {}
        for tr in self.traces:
            if tr.name != round_name:
                continue
            for sp, (secs, n) in tr.self_times().items():
                e = agg.setdefault(sp, [0.0, 0])
                e[0] += secs
                e[1] += n
        rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
        return [{"span": sp, "self_ms": secs * 1e3, "count": n}
                for sp, (secs, n) in rows]


class PathRecorder:
    """Counts what a run sends to the device: each ``solve_step`` (its
    Gp), each probe dispatch (its rows, chunks and Gp), the wall time of
    each ``TorchSolver.solve``, and the last dispatch of each kind. The
    launches such a run must show are compat 2 and pack 1 per solve step
    and per probe chunk."""

    def __init__(self, kernels, cons, keep_steps=False):
        from karpenter_tpu_torch.models import TorchSolver

        self.kernels, self.cons = kernels, cons
        self.keep_steps = keep_steps  # keep every step's inputs in .kept
        self.TorchSolver = TorchSolver
        self.real = dict(step=kernels.solve_step,
                         dispatch=cons.dispatch_counterfactual_rows,
                         solve=TorchSolver.solve)
        self.reset()

    def reset(self):
        self.steps = 0
        self.probes = self.probe_rows = self.probe_chunks = 0
        self.solves = 0
        self.solve_ms: list = []
        self.engines: dict = {}  # solves by the engine that ran them
        self.kept: list = []
        self.last: dict = {}
        self.tag = ""
        self.tagged: dict = {}

    def expected_compat(self) -> int:
        return 2 * (self.steps + self.probe_chunks)

    def expected_pack(self) -> int:
        return self.steps + self.probe_chunks

    def __enter__(self):
        rec, real = self, self.real

        def step(args, **kw):
            rec.steps += 1
            rec.last["step"] = (args, kw)
            if rec.keep_steps:
                rec.kept.append((args, kw))
            return real["step"](args, **kw)

        def dispatch(shared, Gp, Ep, e_avail, max_minv, g_count_k,
                     e_zero_cols, e_free=None, max_bins=1):
            out = real["dispatch"](shared, Gp, Ep, e_avail, max_minv,
                                   g_count_k, e_zero_cols, e_free=e_free,
                                   max_bins=max_bins)
            rows = g_count_k.shape[0]
            chunks = -(-rows // rec.cons.PROBE_CHUNK_ROWS)
            rec.probes += 1
            rec.probe_rows += rows
            rec.probe_chunks += chunks
            rec.last["probe"] = dict(
                args=(shared, Gp, Ep, e_avail, max_minv, g_count_k,
                      e_zero_cols),
                e_free=e_free, max_bins=max_bins, out=out)
            if rec.tag:
                rec.tagged.setdefault(rec.tag, []).append(rec.last["probe"])
            return out

        def solve(solver, *a, **kw):
            t0 = time.perf_counter()
            out = real["solve"](solver, *a, **kw)
            rec.solves += 1
            rec.solve_ms.append((time.perf_counter() - t0) * 1e3)
            engine = solver.last_device_stats.get("engine")
            rec.engines[engine] = rec.engines.get(engine, 0) + 1
            return out

        self.kernels.solve_step = step
        self.cons.dispatch_counterfactual_rows = dispatch
        self.TorchSolver.solve = solve
        return self

    def __exit__(self, *exc):
        self.kernels.solve_step = self.real["step"]
        self.cons.dispatch_counterfactual_rows = self.real["dispatch"]
        self.TorchSolver.solve = self.real["solve"]


def _round_inputs(pods, pools, catalog):
    """``perf/run.py``'s ``_admission_inputs`` through the port: fresh
    clones of the pods, the templates, the catalog by pool and a real
    ``Topology`` over the pools' domains."""
    from karpenter_tpu_torch.controllers.provisioning.provisioner import (
        collect_domains,
    )
    from karpenter_tpu_torch.models import ClaimTemplate
    from karpenter_tpu_torch.models.topology import Topology

    templates = [ClaimTemplate(p) for p in pools]
    its = {p.name: catalog for p in pools}
    fresh = [p.clone() for p in pods]
    domains: dict = {}
    for t in templates:
        collect_domains(domains, t, catalog)
    return fresh, templates, its, Topology(domains=domains, pods=fresh)


def _round_shape(res) -> tuple:
    claims = sorted(
        (c.template.nodepool_name, tuple(sorted(p.name for p in c.pods)),
         tuple(sorted(it.name for it in c.instance_types)))
        for c in res.new_claims if c.pods)
    return claims, sorted(res.pod_errors)


def admission_grid(device, kernels, cuda_kernels, cons, sizes=None) -> dict:
    """priority-mix and gang-mix through ``AdmissionPlane.solve_round``
    with ``TorchSolver(device)`` (None: the card), held against the
    port's tiered-FFD oracle; then preempt-mix through the port's
    ``Environment``. Each run with the launch counts zeroed just before
    and read just after. ``sizes`` overrides the families' sizes (a CPU
    rehearsal)."""
    import torch

    from karpenter_tpu_torch.admission import AdmissionPlane, preempt
    from karpenter_tpu_torch.admission import tiered_ffd_oracle
    from karpenter_tpu_torch.admission.priority import effective_priorities
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.operator import metrics as m
    from karpenter_tpu_torch.workload import (
        _pod,
        gang_mix,
        preempt_env,
        priority_mix,
    )

    sizes = sizes or {}
    sync = torch.cuda.synchronize if device is None else (lambda: None)
    out: dict = {}
    for name, build in (("priority_mix", priority_mix),
                        ("gang_mix", gang_mix)):
        pods, pools, catalog = build(**sizes.get(name, {}))
        c_pods, tpl, its, topo = _round_inputs(pods, pools, catalog)
        solver = TorchSolver(device)
        with PathRecorder(kernels, cons, keep_steps=True) as rec:
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            res = AdmissionPlane().solve_round(solver, c_pods, tpl, its,
                                               topology=topo)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = dict(cuda_kernels.LAUNCHES)
        o_pods, o_tpl, o_its, o_topo = _round_inputs(pods, pools, catalog)
        t0 = time.perf_counter()
        o_res, o_rep = tiered_ffd_oracle(o_pods, o_tpl, o_its,
                                         topology=o_topo)
        oracle_ms = (time.perf_counter() - t0) * 1e3
        prio_of = effective_priorities(c_pods)
        placed = {p.uid for c in res.new_claims for p in c.pods}
        o_placed = {p.uid for c in o_res.new_claims for p in c.pods}
        missed = sorted({prio_of[p.uid] for p in c_pods
                         if p.uid not in placed and p.uid in o_placed},
                        reverse=True)
        tier_order_ok = not missed or not any(
            prio_of[p.uid] < missed[0] for p in c_pods if p.uid in placed)
        partial = 0
        by_gang: dict = {}
        for p in c_pods:
            g = p.metadata.annotations.get(wk.POD_GROUP_ANNOTATION)
            if g:
                by_gang.setdefault(g, []).append(p)
        for members in by_gang.values():
            n_in = sum(1 for p in members if p.uid in placed)
            partial += 0 < n_in < len(members)
        nodes, o_nodes = len(res.new_claims), len(o_res.new_claims)
        out[name] = dict(
            pods=len(pods), types=len(catalog), wall_ms=wall_ms,
            oracle_ms=oracle_ms, nodes=nodes, oracle_nodes=o_nodes,
            node_overhead_pct=100.0 * (nodes - o_nodes) / max(o_nodes, 1),
            scheduled=len(placed), oracle_scheduled=len(o_placed),
            pod_errors=len(res.pod_errors), tier_order_ok=tier_order_ok,
            partial=partial, oracle_gangs_placed=o_rep["gangs_placed"],
            report=res.admission, solver_calls=rec.solves,
            solve_ms=rec.solve_ms, steps=rec.steps,
            compat_launches=launches["compat"],
            compat_expected=rec.expected_compat(),
            pack_launches=launches["pack"], pack_expected=rec.expected_pack(),
            shape=_round_shape(res), last=rec.last.get("step"),
            # the last solve of at most 16 pods: a gang trial
            last_small=next((st for st in reversed(rec.kept)
                             if int(st[0]["g_count"].sum()) <= 16), None))

    # ---- preempt-mix: the eviction ladder through the Environment ----
    n_nodes = sizes.get("preempt_nodes", PREEMPT_NODES)
    env = preempt_env(n_nodes, solver=TorchSolver(device))
    start_bound = len([p for p in env.store.list("pods") if p.node_name])
    reports, shipped, evicted = [], [], []
    real_round = AdmissionPlane.solve_round
    real_exec = preempt.execute_evictions
    real_evict = env.store.evict

    def solve_round(self, *a, **kw):
        res = real_round(self, *a, **kw)
        reports.append(dict(res.admission))
        return res

    def execute(store, candidate, preemptor, **kw):
        got = real_exec(store, candidate, preemptor, **kw)
        shipped.append((preemptor.metadata.name, len(candidate.victims),
                        got))
        return got

    def evict(p):
        evicted.append(p.metadata.owner_references[0]["name"])
        return real_evict(p)

    AdmissionPlane.solve_round = solve_round
    preempt.execute_evictions = execute
    env.store.evict = evict
    try:
        with PathRecorder(kernels, cons) as rec:
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            for i in range(n_nodes):
                env.store.create("pods", _pod(f"hi{i}", 6.0, 4.0,
                                              priority_class_name="high"))
            env.run_until_idle(max_rounds=500)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = dict(cuda_kernels.LAUNCHES)
    finally:
        AdmissionPlane.solve_round = real_round
        preempt.execute_evictions = real_exec
    ctr = env.registry.counter(m.ADMISSION_PREEMPTIONS)
    probes = {k: sum(r["preempt_probes"][k] for r in reports)
              for k in ("batch", "single", "errors")}
    out["preempt_mix"] = dict(
        nodes=n_nodes, wall_ms=wall_ms, start_bound=start_bound,
        hi_bound=len([p for p in env.store.list("pods")
                      if p.node_name and p.metadata.name.startswith("hi")]),
        confirmed=int(ctr.value(outcome="confirmed")),
        declined=int(ctr.value(outcome="declined")),
        evictions=int(env.registry.counter(m.ADMISSION_EVICTIONS).total()),
        evicted=sorted(evicted), shipped=shipped, rounds=len(reports),
        probes=probes, probe_rows=rec.probe_rows,
        probe_dispatches=rec.probes, solver_calls=rec.solves,
        solve_ms=rec.solve_ms, compat_launches=launches["compat"],
        compat_expected=rec.expected_compat(),
        pack_launches=launches["pack"], pack_expected=rec.expected_pack(),
        last_probe=rec.last.get("probe"))
    return out


def admission_phase(cuda_kernels, kernels) -> tuple:
    """The admission plane on the card and on the CPU plain path:
    ``(line, launches, cases)``."""
    from karpenter_tpu_torch.ops import consolidate as cons

    t0 = time.perf_counter()
    card = admission_grid(None, kernels, cuda_kernels, cons)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = admission_grid("cpu", kernels, cuda_kernels, cons)
    cpu_s = time.perf_counter() - t0

    for name, want in (("priority_mix", PRIORITY_EXPECT),
                       ("gang_mix", GANG_EXPECT)):
        got = card[name]
        rep = got["report"]
        seen = dict(tiers=rep["tiers"],
                    solve_dispatches=rep["solve_dispatches"],
                    fused_runs=rep["fused_runs"],
                    scheduled=got["scheduled"],
                    gangs_placed=rep["gangs_placed"],
                    gangs_routed=rep["gangs_routed"],
                    partial=got["partial"])
        check(all(seen[k] == v for k, v in want.items()),
              f"admission {name}: {seen}, want {want}")
        check(got["tier_order_ok"], f"admission {name}: tier order broken")
        check(got["node_overhead_pct"] <= 2.0,
              f"admission {name}: {got['nodes']} nodes against the "
              f"oracle's {got['oracle_nodes']}")
        # a solve re-runs its step when its bins run dry
        check(rep["solve_dispatches"] == got["solver_calls"]
              <= got["steps"],
              f"admission {name}: {got['solver_calls']} solves, "
              f"{got['steps']} solve steps, report "
              f"{rep['solve_dispatches']}")
        check(got["compat_launches"] > 0
              and got["compat_launches"] == got["compat_expected"]
              and got["pack_launches"] == got["pack_expected"],
              f"admission {name}: launches compat {got['compat_launches']} "
              f"and pack {got['pack_launches']} != 2 and 1 per solve step "
              f"({got['compat_expected']}, {got['pack_expected']})")
        check(got["shape"] == cpu[name]["shape"],
              f"admission {name}: the card and the CPU plain path give "
              "different claims or errors")
        check(rep == cpu[name]["report"],
              f"admission {name}: reports differ, card {rep}, "
              f"cpu {cpu[name]['report']}")
    pm = card["preempt_mix"]
    seen = {k: pm[k] for k in PREEMPT_EXPECT}
    check(seen == PREEMPT_EXPECT,
          f"admission preempt_mix: {seen}, want {PREEMPT_EXPECT}")
    # confirm-before-execute: every eviction shipped from a confirmed,
    # complete victim set
    check(len(pm["shipped"]) == pm["confirmed"]
          and sum(ev for _, _, (ev, _) in pm["shipped"]) == pm["evictions"]
          and all(ok for _, _, (_, ok) in pm["shipped"]),
          f"admission preempt_mix: evictions outside confirmed verdicts "
          f"{pm['shipped']}")
    check(pm["probes"]["batch"] + pm["probes"]["single"] > 0
          and pm["probes"]["errors"] == 0,
          f"admission preempt_mix: probes {pm['probes']}")
    check(pm["compat_launches"] > 0
          and pm["compat_launches"] == pm["compat_expected"]
          and pm["pack_launches"] == pm["pack_expected"],
          f"admission preempt_mix: launches compat {pm['compat_launches']} "
          f"and pack {pm['pack_launches']} != 2 and 1 per solve step and "
          f"probe chunk ({pm['compat_expected']}, {pm['pack_expected']})")
    check({k: pm[k] for k in ("hi_bound", "confirmed", "declined",
                              "evictions", "evicted")}
          == {k: cpu["preempt_mix"][k] for k in (
              "hi_bound", "confirmed", "declined", "evictions", "evicted")},
          "admission preempt_mix: the card and the CPU plain path evict "
          "differently")

    # each family's last dispatch again, on the card and on the CPU
    cases, bit_equal, traces = [], {}, {}
    HANDOFF["priority-mix fused"] = card["priority_mix"]["last"]
    HANDOFF["gang trial"] = card["gang_mix"]["last_small"]
    for name, label in (("priority_mix", "fused"), ("gang_mix", "gang")):
        args_gpu, step_kw = card[name]["last"]
        gpu_ms, cpu_ms = check_dispatch(args_gpu, step_kw, kernels,
                                        f"admission {name}")
        bit_equal[name] = dict(gpu_ms=gpu_ms, cpu_ms=cpu_ms,
                               Gp=int(args_gpu["g_demand"].shape[0]),
                               Bp=step_kw["max_bins"])
        cases.append((f"{label} GxT", [args_gpu[k] for k in (
            "g_mask", "g_has", "g_tol", "t_mask", "t_has", "t_tol")]))
        if name == "priority_mix":
            cases.append(("fused 1xB", bins_case(
                args_gpu, int(args_gpu["g_demand"].shape[0]),
                step_kw["max_bins"], kernels)))
            traces["fused_dispatch"] = device_times(
                lambda: kernels.solve_step(args_gpu, **step_kw), 1)
    probe = pm["last_probe"]
    shared, Gp, Ep, e_avail, mm, gk, cols = probe["args"]
    want = cons.dispatch_counterfactual_rows(
        {k: v.cpu() for k, v in shared.items()}, Gp, Ep, e_avail, mm, gk,
        cols, e_free=probe["e_free"], max_bins=probe["max_bins"])
    for a, b in zip(probe["out"], want):
        check(a.shape == b.shape and np.array_equal(a, b),
              "admission preempt_mix: the last probe differs on the CPU")
    Np = cons._pow2(int(gk.shape[0]), lo=4)
    cases += [("preempt GxT", [shared[k] for k in (
                  "g_mask", "g_has", "g_tol", "t_mask", "t_has", "t_tol")]),
              ("preempt 1xNpB", bins_case(shared, Gp, Np * probe["max_bins"],
                                          kernels))]

    def summary(rec, keys):
        return {k: rec[k] for k in keys}

    grid_keys = ("pods", "types", "wall_ms", "oracle_ms", "nodes",
                 "oracle_nodes", "node_overhead_pct", "scheduled",
                 "oracle_scheduled", "pod_errors", "tier_order_ok",
                 "partial", "oracle_gangs_placed", "report", "solver_calls",
                 "solve_ms", "compat_launches")
    pm_keys = ("nodes", "wall_ms", "start_bound", "hi_bound", "confirmed",
               "declined", "evictions", "rounds", "probes", "probe_rows",
               "probe_dispatches", "solver_calls", "solve_ms",
               "compat_launches")
    line = {"admission": {
        "card": {n: summary(card[n], grid_keys)
                 for n in ("priority_mix", "gang_mix")}
        | {"preempt_mix": summary(pm, pm_keys)},
        "cpu": {n: summary(cpu[n], ("wall_ms", "nodes", "solver_calls"))
                for n in ("priority_mix", "gang_mix")}
        | {"preempt_mix": summary(cpu["preempt_mix"], (
            "wall_ms", "evictions", "solver_calls"))},
        "card_s": card_s, "cpu_s": cpu_s,
        "last_dispatch": bit_equal,
        "last_probe": {"rows": int(gk.shape[0]), "Gp": Gp, "Ep": Ep},
        "traces": traces,
    }}
    launches = {k: sum(card[n][f"{k}_launches"] for n in (
        "priority_mix", "gang_mix", "preempt_mix"))
        for k in ("compat", "pack")}
    return line, launches, cases


def spot_leg(device, kernels, cuda_kernels, cons, lam, n_nodes,
             storm=SPOT_STORM) -> dict:
    """One leg of the storm (``workload.spot_storm`` with ``storm``'s
    settings) with ``TorchSolver(device)`` (None: the card): the command
    log, the counts, the solver calls with their wall times, the absorb probe's
    dispatches and answers, and the compat launches, zeroed once the
    fleet stands and read after the storm."""
    import torch

    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.workload import spot_storm

    on_card = device is None
    commands: list = []
    absorbed: list = []
    ordinal: dict = {}
    with PathRecorder(kernels, cons) as rec:
        built = {}

        def on_env(env):
            built["s"] = time.perf_counter() - built.pop("t0")
            built["provision_solves"] = rec.solves
            real_execute = env.disruption._execute
            drain = next(mt for mt in env.disruption.methods
                         if type(mt).__name__ == "InterruptionDrain")
            real_absorb = drain._absorb_probe

            def absorb(cands):
                rec.tag = "absorb"
                try:
                    answer = real_absorb(cands)
                finally:
                    rec.tag = ""
                absorbed.append(answer)
                return answer

            def execute(cmd, method=None):
                for name in sorted((nc.name for nc in env.store.list(
                        "nodeclaims") if nc.name not in ordinal),
                        key=lambda s: int(s.rsplit("-", 1)[-1])):
                    ordinal[name] = len(ordinal)
                commands.append((
                    type(method).__name__, method_rung(method), cmd.action,
                    [ordinal.get(c.name, -1) for c in cmd.candidates],
                    [sorted(it.name for it in claim.instance_types)
                     for claim in cmd.replacements]))
                return real_execute(cmd, method)

            drain._absorb_probe = absorb
            env.disruption._execute = execute
            rec.reset()
            cuda_kernels.reset_launches()
            built["t_storm"] = time.perf_counter()

        built["t0"] = time.perf_counter()
        leg = spot_storm(n_nodes, lam=lam, solver=TorchSolver(device),
                         on_env=on_env, **storm)
        if on_card:
            torch.cuda.synchronize()
        storm_s = time.perf_counter() - built["t_storm"]
        launches = dict(cuda_kernels.LAUNCHES)
    env = leg.pop("env")
    check(env.provisioner.solver.device.type
          == ("cuda" if on_card else "cpu"), "spot: solver device")
    ms = sorted(rec.solve_ms)
    leg.update(
        build_s=built["s"], storm_s=storm_s, commands=commands,
        solver_calls=rec.solves,
        solve_ms_total=sum(ms),
        solve_ms_median=ms[len(ms) // 2] if ms else None,
        solve_ms_p90=ms[int(0.9 * (len(ms) - 1))] if ms else None,
        solve_steps=rec.steps, probe_dispatches=rec.probes,
        probe_rows=rec.probe_rows,
        absorb_probes=len(absorbed),
        absorb_answers={str(k): absorbed.count(k)
                        for k in (True, False, None)},
        absorb_dispatches=len(rec.tagged.get("absorb", [])),
        last_absorb=(rec.tagged.get("absorb") or [None])[-1],
        last_step=rec.last.get("step"), engines=dict(rec.engines),
        compat_launches=launches["compat"],
        compat_expected=rec.expected_compat(),
        pack_launches=launches["pack"], pack_expected=rec.expected_pack())
    del env
    return leg


def absorb_slack(device, kernels, cuda_kernels, cons) -> dict:
    """The absorb probe's deciding answer: two 16-cpu nodes left with
    room to spare (six 5-cpu replicas scaled down to three, voluntary
    disruption closed by a zero budget) and a notice with lead on the
    emptier one. The survivor absorbs its pod, so the row answers True
    and the delete-only drain ships without the host simulation. Returns
    the answers, the commands, the end state, the absorb dispatches and
    the compat launches of the notice's rounds."""
    import random

    import torch

    from karpenter_tpu_torch.api.objects import Deployment, ObjectMeta
    from karpenter_tpu_torch.cloudprovider.catalog import make_instance_type
    from karpenter_tpu_torch.cloudprovider.chaos import ChaosCloud
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.operator import Environment
    from karpenter_tpu_torch.workload import _pod, _pool

    env = Environment(instance_types=[make_instance_type("xl", 16, 64)],
                      solver=TorchSolver(device), enable_disruption=True)
    pool = _pool()
    pool.spec.disruption.consolidate_after = 0.0
    env.create("nodepools", pool)
    for i in range(3):
        env.store.create("deployments", Deployment(
            metadata=ObjectMeta(name=f"d{i}"), replicas=2,
            template=_pod(f"d{i}-tpl", 5.0, 10.0)))
    env.run_until_idle(max_rounds=300)
    pool = env.store.list("nodepools")[0]
    pool.spec.disruption.budgets[0].nodes = "0"
    env.store.update("nodepools", pool)
    for name, replicas in (("d0", 0), ("d1", 1)):
        d = env.store.get("deployments", name)
        d.replicas = replicas
        env.store.update("deployments", d)
    env.run_until_idle(max_rounds=300)
    drain = next(mt for mt in env.disruption.methods
                 if type(mt).__name__ == "InterruptionDrain")
    real_absorb = drain._absorb_probe
    answers, commands = [], []
    real_execute = env.disruption._execute

    def execute(cmd, method=None):
        commands.append((type(method).__name__, method_rung(method),
                         cmd.action, len(cmd.candidates),
                         len(cmd.replacements)))
        return real_execute(cmd, method)

    bound: dict = {}
    for p in env.store.list("pods"):
        if p.node_name:
            bound[p.node_name] = bound.get(p.node_name, 0) + 1
    emptiest = min(env.store.list("nodes"),
                   key=lambda n: (bound.get(n.metadata.name, 0),
                                  n.metadata.name))
    with PathRecorder(kernels, cons) as rec:
        def absorb(cands):
            rec.tag = "absorb"
            try:
                answer = real_absorb(cands)
            finally:
                rec.tag = ""
            answers.append(answer)
            return answer

        drain._absorb_probe = absorb
        env.disruption._execute = execute
        cuda_kernels.reset_launches()
        chaos = ChaosCloud(random.Random(13)).arm(env)
        chaos.inject_notice(emptiest.provider_id, env.clock.now() + 300.0)
        env.run_until_idle(max_rounds=400)
        if device is None:
            torch.cuda.synchronize()
        launches = dict(cuda_kernels.LAUNCHES)
    pods = [p for p in env.store.list("pods")
            if p.metadata.deletion_timestamp is None]
    return dict(
        answers=answers, commands=commands,
        nodes=len(env.store.list("nodes")),
        bound=sum(1 for p in pods if p.node_name),
        unbound=sum(1 for p in pods if not p.node_name),
        absorb_dispatches=len(rec.tagged.get("absorb", [])),
        compat_launches=launches["compat"],
        compat_expected=rec.expected_compat(),
        pack_launches=launches["pack"], pack_expected=rec.expected_pack())


def spot_phase(cuda_kernels, kernels) -> tuple:
    """The storm cut to ``SPOT_STORM_CUT``'s rounds: its risk-aware leg on
    the card and on the CPU plain path, its risk-blind leg on the card:
    ``(line, launches, cases)``."""
    from karpenter_tpu_torch.ops import consolidate as cons
    from karpenter_tpu_torch.workload import spot_gates

    legs, seconds = {}, {}
    # the relax rung's default on the card (on) for both paths, so the
    # CPU plain path takes the same rungs
    with env_knobs(KARPENTER_RELAX="1"):
        for name, want in SPOT_EXPECT_CUT.items():
            t0 = time.perf_counter()
            legs[name] = spot_leg(None, kernels, cuda_kernels, cons,
                                  want["lam"], SPOT_NODES, SPOT_STORM_CUT)
            seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = spot_leg("cpu", kernels, cuda_kernels, cons,
                       SPOT_EXPECT_CUT["risk_aware"]["lam"], SPOT_NODES,
                       SPOT_STORM_CUT)
        seconds["risk_aware_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        slack = {"card": absorb_slack(None, kernels, cuda_kernels, cons),
                 "cpu": absorb_slack("cpu", kernels, cuda_kernels, cons)}
        seconds["absorb_slack"] = time.perf_counter() - t0

    for name, want in SPOT_EXPECT_CUT.items():
        got = legs[name]
        seen = {k: got[k] for k in want if k != "lam"}
        check(seen == {k: v for k, v in want.items() if k != "lam"},
              f"spot {name}: {seen}, want {want}")
        check(got["compat_launches"] > 0
              and got["compat_launches"] == got["compat_expected"]
              and got["pack_launches"] == got["pack_expected"],
              f"spot {name}: launches compat {got['compat_launches']} and "
              f"pack {got['pack_launches']} != 2 and 1 per solve step and "
              f"probe chunk ({got['compat_expected']}, "
              f"{got['pack_expected']})")
    aware, blind = legs["risk_aware"], legs["risk_blind"]
    check(aware["absorb_dispatches"] > 0,
          "spot: the absorb probe never dispatched on the card")
    diff = next((i for i, (a, b) in enumerate(zip(aware["commands"],
                                                  cpu["commands"]))
                 if a != b), min(len(aware["commands"]),
                                 len(cpu["commands"])))
    check(aware["commands"] == cpu["commands"],
          f"spot: the risk-aware leg's commands differ on the card and on "
          f"the CPU plain path from command {diff}: "
          f"{aware['commands'][diff:diff + 2]} against "
          f"{cpu['commands'][diff:diff + 2]}")
    check({k: aware[k] for k in SPOT_EXPECT_CUT["risk_aware"] if k != "lam"}
          == {k: cpu[k] for k in SPOT_EXPECT_CUT["risk_aware"]
              if k != "lam"},
          "spot: the risk-aware leg ends differently on the CPU")
    gates = spot_gates(aware, blind, SPOT_NODES)
    check(gates["cost_beats_blind"] and gates["churn_bound_ok"]
          and gates["zero_late_drain_ok"], f"spot gates: {gates}")
    # the absorb row's True answer ships the delete-only drain
    on_card = slack["card"]
    check(on_card["answers"] == [True] and on_card["commands"] == [
              ("InterruptionDrain", "proactive/delete-only", "delete", 1, 0)]
          and on_card["unbound"] == 0 and on_card["bound"] == 3,
          f"spot: the slack fleet's absorb probe on the card: {on_card}")
    check(on_card["absorb_dispatches"] == 1
          and on_card["compat_launches"] == on_card["compat_expected"]
          and on_card["pack_launches"] == on_card["pack_expected"],
          f"spot: the slack fleet's absorb row did not run on the card "
          f"as counted: {on_card}")
    check({k: v for k, v in on_card.items()
           if not k.startswith(("compat", "pack"))}
          == {k: v for k, v in slack["cpu"].items()
              if not k.startswith(("compat", "pack"))},
          f"spot: the slack fleet differs on the card and on the CPU: "
          f"{slack}")

    # the last absorb row, again on the CPU, and its compat products
    probe = aware["last_absorb"]
    shared, Gp, Ep, e_avail, mm, gk, cols = probe["args"]
    want = cons.dispatch_counterfactual_rows(
        {k: v.cpu() for k, v in shared.items()}, Gp, Ep, e_avail, mm, gk,
        cols, max_bins=probe["max_bins"])
    for a, b in zip(probe["out"], want):
        check(a.shape == b.shape and np.array_equal(a, b),
              "spot: the last absorb row differs on the CPU")
    Np = cons._pow2(int(gk.shape[0]), lo=4)
    cases = [("absorb GxT", [shared[k] for k in (
                 "g_mask", "g_has", "g_tol", "t_mask", "t_has", "t_tol")]),
             ("absorb 1xNpB", bins_case(shared, Gp, Np * probe["max_bins"],
                                        kernels))]
    drop = ("commands", "last_absorb", "last_step")
    HANDOFF["storm solve"] = aware["last_step"]

    def brief(leg):
        return {k: v for k, v in leg.items() if k not in drop} | {
            "n_commands": len(leg["commands"]),
            "methods": sorted({c[0] for c in leg["commands"]})}

    line = {"spot": {
        "nodes": SPOT_NODES, **SPOT_STORM_CUT,
        "reduced": {"nodes": f"{SPOT_NODES_FULL} -> {SPOT_NODES}",
                    "why": "the storm's solver calls grow with the fleet "
                           "(1,244 at 100 nodes) and at 1,000 nodes each "
                           "costs the host ~0.14 s even with the ladder "
                           "on; one leg outlasts the run's time limit",
                    "rounds": SPOT_CUT},
        "risk_aware": brief(aware), "risk_blind": brief(blind),
        "risk_aware_cpu": brief(cpu), "absorb_slack": slack,
        "gates": gates, "seconds": seconds,
        "last_absorb": {"rows": int(gk.shape[0]), "Gp": Gp, "Ep": Ep},
    }}
    launches = {k: aware[f"{k}_launches"] + blind[f"{k}_launches"]
                + slack["card"][f"{k}_launches"] for k in ("compat", "pack")}
    return line, launches, cases

# ---- the engine ladder and the entry point (the seventh main path) ----

# what the earlier phases hand the engines phase: the numpy-able kernel
# arguments of their solves and probes, by name
HANDOFF: dict = {}
# the observability planes' captures the obs phase reads: the operator
# loop's on the card and on the CPU
OBS: dict = {}
# the storm with the ladder at its default gates: the JAX package's
# counts (ISSUE 6's) and its engines per storm solve on the same storm
# (with each leg's fleet build, one native solve, 1,049 host loop and 195
# native; none on the device)
SPOT_ROUTED_ENGINES = {"risk_aware": {"host": 34, "native": 2},
                       "risk_blind": {"host": 1015, "native": 191}}
# the crossover shapes, in the order they are printed, and the engine the
# gates must pick for each ("device" or a rung off the card)
CROSSOVER = (("storm solve", "off"), ("operator confirm", "off"),
             ("gang trial", "off"), ("priority-mix fused", "device"),
             ("headline", "device"))
CROSSOVER_PROBE_ROWS = 128
# the entry point's manifest: one v1 and one v1beta1 NodePool and 64 Pod
# docs of distinct cpu/memory, 40 replicas each (2,560 pods; 64 groups ×
# 144 kwok types clears both gates, so the batch takes the card)
ENTRY_CPUS = (0.25, 0.5, 1, 2, 3, 4, 6, 8)
ENTRY_MEMS = (0.5, 1, 2, 4, 8, 12, 16, 32)
ENTRY_REPLICAS = 40
ENTRY_PODS = len(ENTRY_CPUS) * len(ENTRY_MEMS) * ENTRY_REPLICAS
ENTRY_ARGS = ("--tick", "0.1", "--max-ticks", "40")


class env_knobs:
    """Set environment knobs for a block and restore them after."""

    def __init__(self, **knobs):
        self.knobs = knobs

    def __enter__(self):
        import os

        self.prior = {k: os.environ.get(k) for k in self.knobs}
        for k, v in self.knobs.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        import os

        for k, v in self.prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# every phase before the engines phase keeps the device path: routing off,
# the setting their JAX numbers were taken with
def pinned():
    return env_knobs(KARPENTER_NATIVE_CUTOFF="0")


def _median_ms(fn, reps: int, sync=None) -> tuple:
    """(median wall ms over ``reps`` calls, the last call's result)."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        if sync is not None:
            sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _gate(solver, args_np) -> str:
    """The rung the gates (``ops/engines.py``) send a solve of these
    arguments to: ``host`` (the batch is at most the host cutoff),
    ``native/<reason>`` or ``device``."""
    from karpenter_tpu_torch.ops import engines

    total = int(np.asarray(args_np["g_count"]).sum())
    if total <= engines.host_cutoff():
        return "host"
    reason = solver.native_reason(args_np)
    return "device" if reason is None else f"native/{reason}"


def crossover(kernels, cuda_kernels) -> dict:
    """Each crossover solve's kernel arguments through the native engine,
    the card (``TorchSolver._invoke``: ``solve_step`` and the one host
    read) and the CPU plain path, with each engine's wall time and the
    gates' pick; then one probe chunk through ``solve_probe_batch``, the
    card's ``probe_step`` and the CPU's. The card and the CPU must be
    bit-equal in every output, and the native engine must give the same
    feasibility ``F``; its other outputs are compared and recorded."""
    import torch

    from karpenter_tpu_torch import native
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.ops import consolidate as cons
    from karpenter_tpu_torch.ops import engines

    card, cpu = TorchSolver(), TorchSolver(device="cpu")
    sync = torch.cuda.synchronize
    rows = []
    for name, want in CROSSOVER:
        args_gpu, kw = HANDOFF[name]
        args_cpu = {k: v.cpu() for k, v in args_gpu.items()}
        args_np = {k: v.numpy() for k, v in args_cpu.items()}
        step = (kw["max_bins"], kw.get("level_bits", 20),
                kw.get("max_minv", 0))
        big = int(args_gpu["g_demand"].shape[0]) * int(
            args_gpu["t_mask"].shape[0]) > 1 << 14
        native_ms, nat = _median_ms(
            lambda: native.solve_step(args_np, kw["max_bins"]), 5)
        # the step's static parameters as its compile-ledger key
        card_ms, dev = _median_ms(
            lambda: card._invoke(args_gpu, *step, key=step), 5, sync)
        cpu_ms, plain = _median_ms(
            lambda: cpu._invoke(args_cpu, *step, key=step), 2 if big else 5)
        for key in ("assign", "assign_e", "used", "tmpl", "F"):
            check(np.array_equal(dev[key], plain[key]),
                  f"engines {name}: the card and the CPU differ in {key}")
        check(np.array_equal(nat["F"], dev["F"]),
              f"engines {name}: the native engine's feasibility differs")
        u = dev["used"]
        same = {key: bool(np.array_equal(nat[key], dev[key]))
                for key in ("assign", "assign_e", "used", "tmpl")}
        same["placed_per_group"] = bool(np.array_equal(
            nat["assign"].sum(1) + nat["assign_e"].sum(1),
            dev["assign"].sum(1) + dev["assign_e"].sum(1)))
        same["nodes"] = int(nat["used"].sum()) == int(u.sum())
        gate = _gate(card, args_np)
        check((gate == "device") == (want == "device"),
              f"engines {name}: the gates pick {gate}, want {want}")
        g_count = args_np["g_count"]
        rows.append(dict(
            name=name, G=int((g_count > 0).sum()),
            Gp=int(g_count.shape[0]), T=int((args_np["t_alloc"].max(1)
                                            > 0).sum()),
            Tp=int(args_np["t_alloc"].shape[0]), Bp=kw["max_bins"],
            pods=int(g_count.sum()), gate=gate, native_ms=native_ms,
            card_ms=card_ms, cpu_ms=cpu_ms, nodes=int(u.sum()),
            native_nodes=int(nat["used"].sum()), native_equal=same))

    probe = HANDOFF["probe chunk"]
    shared, Gp, Ep, e_avail, mm, gk, cols = probe["args"]
    n = min(CROSSOVER_PROBE_ROWS, int(gk.shape[0]))
    gk, cols, mb = gk[:n], cols[:n], probe["max_bins"]
    shared_cpu = {k: v.cpu() for k, v in shared.items()}
    shared_np = {k: v.numpy() for k, v in shared_cpu.items()}
    native_ms, nat = _median_ms(
        lambda: cons.dispatch_counterfactual_rows_native(
            shared_np, Gp, Ep, e_avail, mm, gk, cols, max_bins=mb), 5)
    card_ms, dev = _median_ms(
        lambda: cons.dispatch_counterfactual_rows(
            shared, Gp, Ep, e_avail, mm, gk, cols, max_bins=mb), 5, sync)
    cpu_ms, plain = _median_ms(
        lambda: cons.dispatch_counterfactual_rows(
            shared_cpu, Gp, Ep, e_avail, mm, gk, cols, max_bins=mb), 3)
    for label, got in (("native", nat), ("cpu", plain)):
        for a, b in zip(dev, got):
            check(a.shape == b.shape and np.array_equal(a, b),
                  f"engines probe chunk: the card and the {label} rows "
                  "differ")
    G = int((shared_np["g_demand"].max(1) > 0).sum())
    T = int((shared_np["t_alloc"].max(1) > 0).sum())
    gate = "native" if engines.probe_native(G, T) else "device"
    rows.append(dict(name="probe chunk", rows=n, Gp=Gp, Ep=Ep, max_bins=mb,
                     gate=gate, native_ms=native_ms, card_ms=card_ms,
                     cpu_ms=cpu_ms, native_equal={"placed_g": True,
                                                  "used": True}))
    return {"shapes": rows}


def routed_storm(kernels, cuda_kernels) -> dict:
    """The 100-node storm with the ladder at its default gates, both legs
    on ``TorchSolver()``, ``KARPENTER_RELAX=1``: the JAX package's counts,
    the three gates, the engine of every solve (none on the card) and the
    compat launches (0: nothing routed to the card)."""
    from karpenter_tpu_torch.ops import consolidate as cons
    from karpenter_tpu_torch.workload import spot_gates

    legs, seconds = {}, {}
    with env_knobs(KARPENTER_RELAX="1"):
        for name, want in SPOT_EXPECT.items():
            t0 = time.perf_counter()
            legs[name] = spot_leg(None, kernels, cuda_kernels, cons,
                                  want["lam"], SPOT_NODES)
            seconds[name] = time.perf_counter() - t0
    out = {}
    for name, want in SPOT_EXPECT.items():
        got = legs[name]
        seen = {k: got[k] for k in want if k != "lam"}
        check(seen == {k: v for k, v in want.items() if k != "lam"},
              f"engines storm {name}: {seen}, want {want}")
        check(got["engines"] == SPOT_ROUTED_ENGINES[name],
              f"engines storm {name}: solves by engine {got['engines']}, "
              f"want {SPOT_ROUTED_ENGINES[name]}")
        check(got["compat_launches"] == got["compat_expected"]
              and got["pack_launches"] == got["pack_expected"],
              f"engines storm {name}: launches compat "
              f"{got['compat_launches']} and pack {got['pack_launches']} "
              f"!= 2 and 1 per card-routed solve and probe chunk "
              f"({got['compat_expected']}, {got['pack_expected']})")
        out[name] = dict(
            {k: got[k] for k in ("notices", "creates", "proactive_drains",
                                 "deadline_degradations", "end_nodes",
                                 "pods_bound", "end_cost",
                                 "pods_lost_with_lead", "solver_calls",
                                 "solve_ms_total", "solve_ms_median",
                                 "solve_ms_p90", "solve_steps",
                                 "probe_dispatches", "storm_s", "engines",
                                 "compat_launches", "pack_launches")},
            seconds=seconds[name])
    gates = spot_gates(legs["risk_aware"], legs["risk_blind"], SPOT_NODES)
    check(gates["cost_beats_blind"] and gates["churn_bound_ok"]
          and gates["zero_late_drain_ok"], f"engines storm gates: {gates}")
    out["gates"] = gates
    return out


def write_entry_manifest(path: Path) -> None:
    pools = [
        {"apiVersion": "karpenter.sh/v1", "kind": "NodePool",
         "metadata": {"name": "default"},
         "spec": {"template": {"spec": {"expireAfter": "720h"}},
                  "disruption": {
                      "consolidationPolicy": "WhenEmptyOrUnderutilized",
                      "budgets": [{"nodes": "10%"}]}}},
        {"apiVersion": "karpenter.sh/v1beta1", "kind": "NodePool",
         "metadata": {"name": "legacy"},
         "spec": {"weight": 10, "disruption": {
             "consolidationPolicy": "WhenUnderutilized",
             "expireAfter": "720h"}}},
    ]
    pods = [{"kind": "Pod", "name": f"w{i}-{j}", "cpu": c, "memory": m,
             "replicas": ENTRY_REPLICAS}
            for i, c in enumerate(ENTRY_CPUS)
            for j, m in enumerate(ENTRY_MEMS)]
    path.write_text(json.dumps(pools + pods))


def _entry_end(err: str) -> tuple:
    """(nodes, bound pods) from the operator's last stderr line."""
    import re

    last = err.strip().splitlines()[-1]
    m = re.search(r"\((\d+) nodes, (\d+) bound pods\)", last)
    check(m is not None, f"entry point: no end line in {last!r}")
    return int(m.group(1)), int(m.group(2))


def entry_point(kernels, cuda_kernels, workdir: Path) -> dict:
    """``python -m karpenter_tpu_torch`` three ways on one manifest: in
    process with no ``--device`` (the card; the batch must take it, compat
    2 and pack 1 per card solve), in process with ``--device cpu`` (every solve
    native; the same nodes and bound pods), and as a program with
    ``--metrics``, scraped once (every pod bound)."""
    import contextlib
    import io
    import os
    import socket
    import urllib.request

    from karpenter_tpu_torch.__main__ import main as entry_main
    from karpenter_tpu_torch.ops import consolidate as cons

    manifest = workdir / "entry_manifest.json"
    write_entry_manifest(manifest)
    argv = ["--manifest", str(manifest), *ENTRY_ARGS]
    runs = {}
    with env_knobs(KARPENTER_BATCH_IDLE_DURATION="0",
                   KARPENTER_BATCH_MAX_DURATION="0"):
        for label, extra in (("card", []), ("cpu", ["--device", "cpu"])):
            err = io.StringIO()
            with PathRecorder(kernels, cons) as rec, ObsCapture() as planes:
                cuda_kernels.reset_launches()
                t0 = time.perf_counter()
                with contextlib.redirect_stderr(err):
                    rc = entry_main(argv + extra)
                wall_s = time.perf_counter() - t0
                launches = dict(cuda_kernels.LAUNCHES)
            OBS[f"entry {label}"] = planes
            check(rc == 0, f"entry point {label}: exit code {rc}")
            nodes, bound = _entry_end(err.getvalue())
            runs[label] = dict(
                wall_s=wall_s, nodes=nodes, bound=bound,
                solver_calls=rec.solves, engines=dict(rec.engines),
                solve_ms=rec.solve_ms, solve_steps=rec.steps,
                compat_launches=launches["compat"],
                compat_expected=rec.expected_compat(),
                pack_launches=launches["pack"],
                pack_expected=rec.expected_pack())
        card, cpu = runs["card"], runs["cpu"]
        check(card["bound"] == ENTRY_PODS and card["nodes"] > 0,
              f"entry point card: {card['nodes']} nodes, {card['bound']} "
              f"of {ENTRY_PODS} pods bound")
        check(card["engines"].get("cuda", 0) >= 1,
              f"entry point card: the batch did not take the card: "
              f"{card['engines']}")
        check(card["compat_launches"] > 0
              and card["compat_launches"] == card["compat_expected"]
              and card["pack_launches"] == card["pack_expected"],
              f"entry point card: launches compat {card['compat_launches']}"
              f" and pack {card['pack_launches']} != 2 and 1 per card "
              f"solve ({card['compat_expected']}, {card['pack_expected']})")
        check(set(cpu["engines"]) <= {"native", "host"}
              and cpu["engines"].get("native", 0) >= 1
              and cpu["compat_launches"] == cpu["pack_launches"] == 0,
              f"entry point cpu: solves by engine {cpu['engines']}")
        check((cpu["nodes"], cpu["bound"]) == (card["nodes"], card["bound"]),
              f"entry point: the card ends with {card['nodes']} nodes and "
              f"{card['bound']} pods bound, --device cpu with "
              f"{cpu['nodes']} and {cpu['bound']}")

        # as a program, with the metrics endpoint on a free port
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, KARPENTER_METRICS_PORT=str(port),
                   KARPENTER_METRICS_BIND="127.0.0.1")
        env["KARPENTER_TRACE_DIR"] = str(workdir / "program-traces")
        t0 = time.perf_counter()
        err_path = workdir / "entry_program.err"
        # the planes' endpoints, polled while the program runs: the last
        # answer of each is kept (the program exits after its ticks)
        planes: dict = {}
        with open(err_path, "w") as err_file:
            proc = subprocess.Popen(
                [sys.executable, "-m", "karpenter_tpu_torch", *argv,
                 "--metrics"], cwd=Path(__file__).resolve().parent, env=env,
                stdout=subprocess.DEVNULL, stderr=err_file)
            try:
                body = None
                while proc.poll() is None:
                    try:
                        if body is None:
                            body = urllib.request.urlopen(
                                f"http://127.0.0.1:{port}/metrics",
                                timeout=5).read().decode()
                        got = {}
                        for path in ("/slo", "/introspect", "/usage"):
                            with urllib.request.urlopen(
                                    f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
                                got[path] = (r.status,
                                             r.headers["Content-Type"],
                                             json.loads(r.read().decode()))
                        planes = got
                    except (OSError, ValueError):
                        pass
                    time.sleep(0.2)
                proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall_s = time.perf_counter() - t0
        err = err_path.read_text()
        check(proc.returncode == 0,
              f"entry point program: exit code {proc.returncode}: "
              f"{err[-2000:]}")
        check(body is not None and "karpenter_" in body,
              "entry point program: /metrics was never scraped")
        nodes, bound = _entry_end(err)
        check(bound == ENTRY_PODS,
              f"entry point program: {bound} of {ENTRY_PODS} pods bound")
        runs["program"] = dict(wall_s=wall_s, nodes=nodes, bound=bound,
                               metrics_bytes=len(body or ""),
                               last_line=err.strip().splitlines()[-1])
        OBS["entry program"] = dict(planes, nodes=nodes, bound=bound)
    runs["pods"] = ENTRY_PODS
    return runs


def engines_phase(kernels, cuda_kernels, workdir: Path) -> tuple:
    """The engine ladder and the entry point with routing at its default
    gates: ``(line, launches)``. The native engine must build (g++ is
    there: ``nvcc`` needs it too)."""
    from karpenter_tpu_torch import native

    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError):
        gxx = None
    check(native.available(), f"engines: the native engine did not build "
                              f"(g++: {gxx})")
    seconds = {}
    with env_knobs(KARPENTER_NATIVE_CUTOFF=None):
        t0 = time.perf_counter()
        shapes = crossover(kernels, cuda_kernels)
        seconds["crossover"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        storm = routed_storm(kernels, cuda_kernels)
        seconds["storm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        entry = entry_point(kernels, cuda_kernels, workdir)
        seconds["entry_point"] = time.perf_counter() - t0
    line = {"engines": {"gxx": gxx, "native_library": str(native.lib_path()),
                        "crossover": shapes, "storm": storm,
                        "entry_point": entry, "seconds": seconds}}
    launches = {k: storm["risk_aware"][f"{k}_launches"]
                + storm["risk_blind"][f"{k}_launches"]
                + entry["card"][f"{k}_launches"] for k in ("compat", "pack")}
    return line, launches


# tests/test_obs.py takes 7 pairs; on an H100 (NVIDIA H100 80GB HBM3,
# 700 W) the headline's wall spreads over 312-667 ms from solve to solve
# with the tracer off, falling over a run's first dozen solves, and 7
# samples a side left one side's minimum an outlier 40 ms below the
# other's, wider than the bound; 15 left it 24 ms below against a 27 ms
# bound. 25 pairs after 6 untimed solves let both minimums reach the
# floor
OBS_PAIRS, OBS_WARMUP = 25, 6


def obs_headline(solver, pods, templates, its, cuda_kernels) -> dict:
    """The headline solve with the tracer on and off, on clones of one
    batch: after ``OBS_WARMUP`` untimed solves, ``OBS_PAIRS`` interleaved
    pairs (alternating which side runs first, the garbage collector held
    off inside each timing), each side's minimum, which must hold
    ``tests/test_obs.py``'s bound (on <= off x 1.02 + 20 ms). Then one
    traced solve under torch.profiler, with the LP floor off so that
    every kernel of the solve runs inside its ``solve.kernel`` span: the
    span must be at least the device time the profiler records, which
    proves the span waits for the card. Compat must launch twice and pack
    once per dispatch throughout."""
    import gc

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from karpenter_tpu_torch import obs

    expected = [0]

    def one(traced: bool) -> tuple:
        batch = [p.clone() for p in pods]
        obs.configure(enabled=traced)
        tr = None
        # the collector's pauses over 50k-pod batches are the noise that
        # would swamp the tracer's cost: collected before, held off during
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            if traced:
                with obs.round_trace("headline") as tr:
                    solver.solve(batch, templates, its)
            else:
                solver.solve(batch, templates, its)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            gc.enable()
        st = solver.last_device_stats
        expected[0] += 1 + st.get("bin_growths", 0)  # dispatches
        return ms, tr

    # untimed warm-up: the first solves of a run are slower as the host
    # settles, and would bias whichever side they fell on
    for i in range(OBS_WARMUP):
        one(i % 2 == 1)
    expected[0] = 0
    cuda_kernels.reset_launches()
    off, on = [], []
    for i in range(OBS_PAIRS):  # interleaved, alternating the first side
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            (on if traced else off).append(one(traced)[0])
    obs.configure(enabled=True)
    check(min(on) <= min(off) * 1.02 + 20.0,
          f"obs: the tracer costs the headline solve too much: on "
          f"{min(on):.1f} ms against off {min(off):.1f} ms "
          f"(samples on {on}, off {off})")
    with env_knobs(KARPENTER_RELAX="0"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, tr = one(True)
    launches = dict(cuda_kernels.LAUNCHES)
    check(launches["compat"] == 2 * expected[0]
          and launches["pack"] == expected[0],
          f"obs: launches {launches} != compat 2 and pack 1 per dispatch "
          f"over {expected[0]} dispatches")
    device_us = sum(ev.duration_ns() / 1e3
                    for ev in prof.profiler.kineto_results.events()
                    if ev.device_type() == DeviceType.CUDA)
    spans = [sp for sp in tr.spans() if sp.name == "solve.kernel"]
    span_ms = sum(sp.dur for sp in spans) * 1e3
    check(spans and device_us > 0 and span_ms >= device_us / 1e3,
          f"obs: solve.kernel spans {span_ms:.3f} ms < the solve's device "
          f"time {device_us / 1e3:.3f} ms")
    names = {sp.name for sp in tr.spans()}
    check({"tensorize.build", "solve.kernel", "solve.dispatch",
           "solve.block", "solve.decode"} <= names,
          f"obs: the headline round's spans {sorted(names)}")
    return {"pairs": OBS_PAIRS, "on_ms": on, "off_ms": off,
            "on_min_ms": min(on), "off_min_ms": min(off),
            "on_median_ms": statistics.median(on),
            "off_median_ms": statistics.median(off),
            "overhead_ms": min(on) - min(off),
            "profiled": {"solve_kernel_span_ms": span_ms,
                         "device_ms": device_us / 1e3,
                         "spans": len(spans),
                         "top_self_ms": tr.summary(top=8)},
            "compat_launches": launches["compat"],
            "pack_launches": launches["pack"]}


def _census(events: list) -> dict:
    """Distinct nodes launched and registered, and distinct pods bound, in
    a capture's timeline events."""
    out = {"launch": set(), "register": set(), "bind": set()}
    for ev in events:
        ev = dict(ev)
        if ev["kind"] in ("launch", "register"):
            out[ev["kind"]].add(ev["node"])
        elif ev["kind"] == "bind":
            out["bind"].add(ev["pod"])
    return {k: len(v) for k, v in out.items()}


def obs_phase(card: str, trace_dir: Path, headline: dict) -> dict:
    """The observability planes on the card, from the captures the
    earlier phases made: the operator loop's decision records, timeline
    events and compile ledger equal on the card and on the CPU plain
    path, its rounds' top spans by self time, the longest disrupt round's
    leaf coverage (>= 0.95, ``tests/test_obs.py``'s acceptance), the
    Chrome dumps in ``trace_dir`` valid, ``python -m
    karpenter_tpu_torch.obs report`` over the saved ``/introspect``
    snapshot exiting 0; the entry point's timeline (launch and register
    for every node, bind for every pod) in process and through the
    program's ``/slo``, ``/introspect`` and ``/usage``."""
    card_obs, cpu_obs = OBS["operator"]
    for what in ("decisions", "events", "ledger", "stats"):
        a, b = getattr(card_obs, what), getattr(cpu_obs, what)
        diff = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b))) if isinstance(a, list) else None
        check(a == b, f"obs: the operator loop's {what} differ on the card "
                      f"and on the CPU plain path (from entry {diff})")
    check(card_obs.decisions and card_obs.events and card_obs.ledger,
          "obs: the operator loop left the planes empty")
    disrupt = [t for t in card_obs.traces if t.name == "disrupt"]
    check(disrupt, "obs: no disrupt round was kept")
    longest = max(disrupt, key=lambda t: t.root.dur or 0.0)
    coverage = longest.leaf_coverage()
    check(coverage >= 0.95,
          f"obs: the longest disrupt round's leaf coverage {coverage:.4f} "
          f"< 0.95: {longest.summary(top=8)}")
    dumps = sorted(trace_dir.glob("*.trace.json"))
    for path in dumps:
        doc = json.loads(path.read_text())
        check(doc["traceEvents"] and doc["displayTimeUnit"] == "ms",
              f"obs: {path.name} is not a trace-event file")
    intro = trace_dir / "introspect.json"
    intro.write_text(json.dumps(card_obs.introspect))
    report = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.obs", "report", "--file",
         str(intro), "--timeline"], capture_output=True, text=True,
        timeout=120, cwd=Path(__file__).resolve().parent)
    check(report.returncode == 0 and "decision plane" in report.stdout
          and "fleet ledger" in report.stdout,
          f"obs: report exited {report.returncode}: {report.stderr[-2000:]}")

    entry = {}
    for label in ("card", "cpu"):
        census = _census(OBS[f"entry {label}"].events)
        entry[label] = census
        check(census["launch"] == census["register"] > 0
              and census["bind"] == ENTRY_PODS,
              f"obs: the entry point's timeline ({label}): {census}")
    check(entry["card"] == entry["cpu"],
          f"obs: the entry point's timeline, card {entry['card']} against "
          f"cpu {entry['cpu']}")
    prog = OBS["entry program"]
    for path in ("/slo", "/introspect", "/usage"):
        check(path in prog and prog[path][0] == 200
              and prog[path][1] == "application/json",
              f"obs: the program's {path} did not answer 200 with JSON")
    kinds = prog["/introspect"][2]["timeline"]["ring"]["kinds"]
    check(kinds.get("launch") == kinds.get("register") == prog["nodes"]
          and kinds.get("bind") == prog["bound"] == ENTRY_PODS,
          f"obs: the program's timeline kinds {kinds}, want "
          f"{prog['nodes']} launches and registrations and {ENTRY_PODS} "
          "binds")
    check("compile_ledger" in prog["/slo"][2]
          and "total_device_seconds" in prog["/usage"][2],
          "obs: the program's /slo or /usage lacks its keys")
    return {"obs": {
        "card": card,
        "operator": {
            "decisions": len(card_obs.decisions),
            "events": len(card_obs.events),
            "ledger": len(card_obs.ledger),
            "cold": sum(1 for *_, cold in card_obs.ledger if cold),
            "stats": card_obs.stats,
            "rounds": len(card_obs.traces),
            "anomalies": sorted({k for t in card_obs.traces
                                 for k, _, _ in t.anomalies}),
            "top_self_ms": {name: card_obs.top_self_ms(name)
                            for name in ("provision", "disrupt")},
            "cpu_top_self_ms": {name: cpu_obs.top_self_ms(name)
                                for name in ("provision", "disrupt")},
            "longest_disrupt_ms": (longest.root.dur or 0.0) * 1e3,
            "leaf_coverage": coverage,
            "dumps": len(dumps),
            "report_lines": len(report.stdout.splitlines()),
        },
        "headline": headline,
        "entry_point": {"in_process": entry, "program": {
            "kinds": kinds, "nodes": prog["nodes"], "bound": prog["bound"],
            "usage_total_s": prog["/usage"][2]["total_device_seconds"],
            "sites": sorted(prog["/introspect"][2]["sites"])}},
    }}



# ---- replay capsules and the solver service (the ninth main path) ----

# the capsule phase's seams (obs/capsule.py SEAMS less the mesh's, which
# the mesh phase captures and replays): each one the runs below reach
CAPSULE_SEAMS = ("solver.invoke", "probe.dispatch", "global.dispatch",
                 "relax.dispatch", "interruption.dispatch",
                 "preempt.dispatch", "service.solve")
# the multi-tenant fleet (perf/run.py run_multitenant): 8 tenants x 3
# rounds x 40 pods over benchmark_catalog(40), one default NodePool,
# coalescing window 4 ms
TENANTS, TENANT_ROUNDS, TENANT_PODS = 8, 3, 40


class CaptureSpy:
    """Every replay capture the process records while open: the count and
    the last record per seam (the record is a reference, as the trace
    holds it)."""

    def __init__(self):
        from karpenter_tpu_torch.obs import capsule

        self.capsule = capsule
        self.counts: dict = {}
        self.last: dict = {}

    def __enter__(self):
        self.real = self.capsule.record_capture

        def spy(seam, *a, **kw):
            rec = self.real(seam, *a, **kw)
            if rec is not None:
                self.counts[seam] = self.counts.get(seam, 0) + 1
                self.last[seam] = rec
            return rec

        self.capsule.record_capture = spy
        return self

    def __exit__(self, *exc):
        self.capsule.record_capture = self.real


def _capsules_by_seam(directory: Path) -> dict:
    """``{seam: [paths]}`` of the capsule files in ``directory``, oldest
    first."""
    from karpenter_tpu_torch.obs import capsule

    out: dict = {}
    for path in sorted(directory.glob("*.capsule.npz"),
                       key=lambda p: p.stat().st_mtime_ns):
        out.setdefault(capsule.load(str(path)).seam, []).append(path)
    return out


def replay_both(path: Path) -> dict:
    """One capsule replayed on the card and on the CPU plain path, each
    graded ``exact`` or the run fails; the wall of each replay."""
    import torch

    from karpenter_tpu_torch.obs import capsule

    cap = capsule.load(str(path))
    out = {"seam": cap.seam, "engine": cap.engine,
           "bytes": int(cap.meta["nbytes"]), "file_bytes": path.stat().st_size}
    for name, device in (("card", "cuda"), ("cpu", "cpu")):
        t0 = time.perf_counter()
        r = capsule.replay(cap, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{name}_rung"] = r["rung"]
        check(r["parity"] == "exact" and r["rung_match"],
              f"capsule {path.name} ({cap.seam}) replays {r['parity']} on "
              f"the {name}: {r}")
    return out


def capsule_phase(cuda_kernels, kernels, workdir: Path) -> tuple:
    """Replay capsules on the card: ``KARPENTER_CAPSULE=1`` over the
    headline solve and one operator round of each kind — provisioning
    and a disruption round of the 2,000-node fleet, an interruption
    notice (``absorb_slack``) and the preemption ladder (``preempt_env``)
    — the recorder writing one capsule per round; every seam the runs
    reach must have a capsule (a seam whose capture a later one of the
    same round displaced is written from its last capture), and each
    replays ``exact`` on the card and on the CPU. The headline capsule's
    A/B table (device, native, host) is printed, and the CLI runs as a
    program on it. Returns ``(line, launches, cases)``: the row seams'
    compat products join the compat cases."""
    import torch

    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.controllers.disruption.helpers import (
        get_candidates,
    )
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.obs import capsule
    from karpenter_tpu_torch.obs.__main__ import render_ab
    from karpenter_tpu_torch.ops import consolidate as cons
    from karpenter_tpu_torch.workload import (
        _pod,
        build_workload,
        consolidation_env,
        preempt_env,
    )

    cdir = workdir / "capsules"
    cdir.mkdir()
    obs.configure(dump_dir=str(cdir))
    launches = {"compat": 0, "pack": 0}

    def take() -> None:
        for k in launches:
            launches[k] += cuda_kernels.LAUNCHES[k]
        cuda_kernels.reset_launches()

    runs = {}
    # the device path, as phases 3-10 keep it: every seam on the card
    with pinned(), env_knobs(KARPENTER_CAPSULE="1",
                             KARPENTER_TRACE_DIR=str(cdir)), \
            CaptureSpy() as spy:
        cuda_kernels.reset_launches()
        # the headline, as one traced round
        t0 = time.perf_counter()
        pods, templates, its = build_workload(N_PODS, N_TYPES)
        with obs.round_trace("capsule-headline"):
            res = TorchSolver().solve(pods, templates, its)
        torch.cuda.synchronize()
        check(res.scheduled_pod_count() == N_PODS, "capsule headline")
        runs["headline_s"] = time.perf_counter() - t0
        take()
        # the operator loop: provisioning rounds, then one disruption round
        t0 = time.perf_counter()
        env = consolidation_env(OPERATOR_NODES, solver=TorchSolver())
        start_nodes = len(env.store.list("nodes"))
        env.clock.step(20.0)
        env.run_until_idle(max_rounds=500)
        torch.cuda.synchronize()
        runs["operator_s"] = time.perf_counter() - t0
        runs["operator_nodes"] = [start_nodes, len(env.store.list("nodes"))]
        check(runs["operator_nodes"][1] < start_nodes,
              f"capsule: the disruption round retired nothing {runs}")
        # the per-candidate probe over the round's survivors, as the
        # single-node method asks it
        d = env.disruption
        cands = get_candidates(d.cluster, d.store, d.cloud, d.clock,
                               queue=d.queue)
        with obs.round_trace("capsule-probe"):
            single = cons.batched_single_feasible(
                d.provisioner, d.cluster, d.store, list(cands))
        check(single is not None, "capsule: the probe did not dispatch")
        take()
        # an interruption notice the survivors absorb
        t0 = time.perf_counter()
        slack = absorb_slack(None, kernels, cuda_kernels, cons)
        check(slack["answers"] == [True], f"capsule: absorb {slack}")
        runs["interruption_s"] = time.perf_counter() - t0
        take()
        # the preemption ladder
        t0 = time.perf_counter()
        penv = preempt_env(PREEMPT_NODES, solver=TorchSolver())
        for i in range(PREEMPT_NODES):
            penv.store.create("pods", _pod(f"hi{i}", 6.0, 4.0,
                                           priority_class_name="high"))
        penv.run_until_idle(max_rounds=500)
        torch.cuda.synchronize()
        runs["preempt_s"] = time.perf_counter() - t0
        take()
    written = _capsules_by_seam(cdir)
    explicit = {}
    for seam, rec in spy.last.items():
        if seam not in written:
            # a later capture of the same round took the round's capsule
            path = capsule.write_capsule(
                rec, path=str(cdir / f"last-{seam}.capsule.npz"),
                why="forced")
            check(path is not None, f"capsule: {seam} was not written")
            written[seam] = [Path(path)]
            explicit[seam] = path
    reached = sorted(spy.counts)
    want = [s for s in CAPSULE_SEAMS if s != "service.solve"]
    check(set(reached) == set(want),
          f"capsule: the runs reached {reached}, not every seam of {want}")
    per_seam = {}
    paths = {}
    cuda_kernels.reset_launches()
    for seam in reached:
        path = written[seam][-1]
        paths[seam] = path
        per_seam[seam] = dict(replay_both(path), captures=spy.counts[seam],
                              capsules=len(written[seam]),
                              from_recorder=seam not in explicit)
    take()
    # the headline capsule's A/B table and the CLI as a program
    head = written["solver.invoke"][0]
    cap = capsule.load(str(head))
    check(cap.meta.get("round") == "capsule-headline",
          f"capsule: the first solver.invoke capsule is {cap.meta}")
    rows = capsule.ab_compare(cap, device="cuda")
    print(render_ab(rows), flush=True)
    by_rung = {r["rung"]: r for r in rows}
    for rung in ("device", "native", "host"):
        check(by_rung[rung].get("eligible", True),
              f"capsule: the {rung} rung is ineligible: {by_rung[rung]}")
    check(by_rung["device"]["parity"] == "exact", f"capsule A/B {rows}")
    per_seam["solver.invoke"]["headline"] = replay_both(head)
    cli = {}
    for label, path, extra in (("card", head, ["--ab"]),
                               ("cpu", paths["interruption.dispatch"],
                                ["--device", "cpu"])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "karpenter_tpu_torch.obs", "replay",
             str(path), "--json", *extra],
            capture_output=True, text=True, timeout=300,
            cwd=str(Path(__file__).resolve().parent))
        check(proc.returncode == 0,
              f"capsule CLI ({label}) rc {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        reply = json.loads(proc.stdout.strip().splitlines()[-1])
        check(reply["replay"]["parity"] == "exact", f"capsule CLI {reply}")
        cli[label] = dict(rc=proc.returncode, seconds=time.perf_counter() - t0,
                          rung=reply["replay"]["rung"],
                          ab=[(r["rung"], r.get("parity"))
                              for r in reply.get("ab", [])])
    line = {"capsule": {
        "seams": per_seam, "explicit": sorted(explicit), "runs": runs,
        "ab_headline": [{k: r.get(k) for k in ("rung", "eligible", "parity",
                                               "nodes", "ms", "why")}
                        for r in rows],
        "cli": cli, "index": len(capsule.index()),
        "compat_launches": launches["compat"],
        "pack_launches": launches["pack"]}}
    # the row seams' compat products at their own shapes (the headline
    # capsule's are the main path's)
    cases = [case for seam in reached if seam != "solver.invoke"
             for case in capsule_cases(f"capsule {seam}",
                                       capsule.load(str(paths[seam])),
                                       kernels)]
    return line, dict(launches), cases


def coalesce_burst(server, n: int) -> dict:
    """``n`` tenants' first-round snapshots (``workload.
    multitenant_workload``), tensorized here first, then sent as
    stateless Solve requests from ``n`` threads released together, so
    they reach the server inside one coalescing window: the fold's
    batch sizes from the server's ``/metrics``."""
    import threading
    import urllib.request

    import grpc

    from karpenter_tpu_torch.api.nodepool import NodePool
    from karpenter_tpu_torch.api.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.catalog import benchmark_catalog
    from karpenter_tpu_torch.models import ClaimTemplate, TorchSolver
    from karpenter_tpu_torch.service import solver_service as svc
    from karpenter_tpu_torch.workload import multitenant_workload

    target, metrics_port = server
    pool = NodePool(metadata=ObjectMeta(name="default"))
    its = {pool.name: benchmark_catalog(40)}
    fams: dict = {}
    with CaptureSpy() as spy:
        for i in range(n):
            TorchSolver(device="cpu").solve(
                multitenant_workload(i, 0, TENANT_PODS), [ClaimTemplate(pool)],
                its)
            rec = spy.last["solver.invoke"]
            meta = {k: int(rec["meta"][k])
                    for k in ("max_bins", "level_bits", "max_minv")}
            fam = tuple(sorted((k, v.shape) for k, v in rec["inputs"].items()))
            fams.setdefault((fam, meta["max_bins"]), []).append(
                svc._pack(rec["inputs"], meta))
    payloads = max(fams.values(), key=len)
    check(len(payloads) >= 2, f"coalesce burst: no two tenants share a "
                              f"shape family ({len(fams)} families)")

    def coalesced() -> float:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{metrics_port}/metrics", timeout=10) as r:
            text = r.read().decode()
        return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                   if line.startswith(
                       "karpenter_solver_coalesced_requests_total"))

    before = coalesced()
    chan = grpc.insecure_channel(target, options=svc._GRPC_OPTS)
    call = chan.unary_unary(svc._METHOD, request_serializer=None,
                            response_deserializer=None)
    gate = threading.Barrier(len(payloads))
    outs: dict = {}

    def fire(i):
        gate.wait()
        outs[i] = svc._unpack(call(payloads[i], timeout=120))[0]

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(payloads))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_ms = (time.perf_counter() - t0) * 1e3
    chan.close()
    check(len(outs) == len(payloads), "coalesce burst: a request failed")
    return {"requests": len(payloads), "families": len(fams),
            "coalesced": coalesced() - before, "wall_ms": wall_ms}


def batched_vs_single(rows: list, kernels) -> dict:
    """One batched dispatch of ``rows`` (same-shape numpy snapshots, from
    the service's capsules) against the same rows as single dispatches on
    the card: compat launches, device time, kernels and wall of each, and
    the outputs equal."""
    import torch

    from karpenter_tpu_torch.models.solver import batched_invoke
    from karpenter_tpu_torch.ops import cuda_kernels

    dev = torch.device("cuda")
    args = [c.args() for c in rows]
    mb = int(rows[0].static("max_bins"))
    lb = int(rows[0].static("level_bits", 20))
    mv = int(rows[0].static("max_minv", 0))

    def batched():
        return batched_invoke(args, mb, level_bits=lb, max_minv=mv)

    def singles():
        return [kernels.unpack_solve(kernels.packed_solve(
            kernels.from_kernel_args(a, dev), mb, lb, mv,
            fma_rem=False).cpu().numpy(), a, mb) for a in args]

    out = {"n": len(args), "Gp": int(args[0]["g_mask"].shape[0]),
           "Tp": int(args[0]["t_mask"].shape[0]), "Bp": mb}
    results = {}
    for name, fn in (("batched", batched), ("single", singles)):
        fn()
        torch.cuda.synchronize()
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        results[name] = fn()
        out[f"{name}_wall_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{name}_compat_launches"] = cuda_kernels.LAUNCHES["compat"]
        out[f"{name}_pack_launches"] = cuda_kernels.LAUNCHES["pack"]
        out[f"{name}_trace"] = device_times(fn, 3, warm_up=False)
    for a, b in zip(results["batched"], results["single"]):
        for k in ("assign", "assign_e", "used", "tmpl", "F"):
            check(np.array_equal(a[k], b[k]),
                  f"batched row differs from its single dispatch in {k}")
    return out


def service_phase(kernels, workdir: Path) -> tuple:
    """The solver service on the card: ``python -m karpenter_tpu_torch.
    service.solver_service`` as its own process (coalescing window 4 ms,
    ``KARPENTER_CAPSULE=1``), the headline through ``RemoteSolver`` equal
    to the in-process ``TorchSolver`` solve bit for bit (``KARPENTER_RELAX
    =0`` on both: the client is a CPU process, whose bin-axis plan runs
    no LP floor), then the multi-tenant fleet (``workload.
    run_multitenant``) with every tenant's claims equal to its solo
    in-process oracle on the card, full uploads = tenants, no resync, no
    remote fallback, and at least one coalesced batched dispatch on the
    card whose rows replay exactly on the CPU plain path (from the
    server's capsules). The server and the oracles run with routing off
    (``pinned``), as phases 3-10 do: the gates would send the tenants'
    40-pod solves to the native engine, in process and in the server's
    fold alike. Returns ``(line, launches, cases)``: the server's compat
    launches, read from its log, and a batched row's compat products."""
    import re

    import grpc
    import torch

    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.obs import capsule
    from karpenter_tpu_torch.service import RemoteSolver
    from karpenter_tpu_torch.workload import (
        build_workload,
        run_multitenant,
        solver_server,
    )

    sdir = workdir / "service"
    sdir.mkdir()
    log = workdir / "solver_service.log"
    line: dict = {"grpc": grpc.__version__, "transport": "grpc loopback"}
    t0 = time.perf_counter()
    with pinned(), solver_server(env={"KARPENTER_CAPSULE": "1",
                                      "KARPENTER_TRACE_DIR": str(sdir),
                                      "KARPENTER_COALESCE_WINDOW_MS": "4"},
                                 log=str(log)) as server:
        line["server_start_s"] = time.perf_counter() - t0
        # ---- the headline through the wire ----
        with env_knobs(KARPENTER_RELAX="0"), CaptureSpy() as spy:
            pods, templates, its = build_workload(N_PODS, N_TYPES)
            t1 = time.perf_counter()
            local = TorchSolver().solve(pods, templates, its)
            torch.cuda.synchronize()
            local_ms = (time.perf_counter() - t1) * 1e3
            want = spy.last["solver.invoke"]
            pods, templates, its = build_workload(N_PODS, N_TYPES)
            remote_solver = RemoteSolver(server[0])
            t1 = time.perf_counter()
            remote = remote_solver.solve(pods, templates, its)
            remote_ms = (time.perf_counter() - t1) * 1e3
            got = spy.last["solver.invoke"]
        check(remote_solver.last_device_stats["engine"] == "remote"
              and remote_solver._route == ("service", "ok"),
              f"the headline did not cross the wire: {remote_solver._route}")
        check(got["meta"]["engine"] == "remote", "service: client capture")
        for side in ("inputs", "outputs"):
            w, g = want[side], got[side]
            check(set(w) == set(g) and all(
                np.asarray(w[k]).dtype == np.asarray(g[k]).dtype
                and np.array_equal(w[k], g[k]) for k in w),
                f"service: the headline's {side} differ through the wire")
        check(local.node_count() == remote.node_count() == 1128,
              f"service headline nodes: in process {local.node_count()}, "
              f"through the wire {remote.node_count()}")
        check(remote.scheduled_pod_count() == N_PODS, "service headline pods")
        line["headline"] = dict(nodes=remote.node_count(),
                                in_process_ms=local_ms, remote_ms=remote_ms,
                                bit_equal=True)
        # ---- the multi-tenant fleet ----
        t1 = time.perf_counter()
        row = run_multitenant(TENANTS, TENANT_ROUNDS, TENANT_PODS,
                              server=server, oracle_device="cuda")
        line["multitenant_s"] = time.perf_counter() - t1
        # ---- a burst released together, which the window must fold ----
        line["burst"] = coalesce_burst(server, TENANTS)
        check(line["burst"]["coalesced"] >= 2,
              f"the burst was not coalesced: {line['burst']}")
    check("error" not in row, f"multi-tenant fleet: {row}")
    check(row["isolation_ok"], f"a tenant's claims differ from its solo "
                               f"oracle: {row}")
    check(row["deltas"]["full_uploads"] == TENANTS
          and row["deltas"]["resyncs"] == 0,
          f"multi-tenant deltas: {row['deltas']}")
    check(row["client_fallbacks"] == 0 and not row["degraded"],
          f"multi-tenant fallbacks: {row['client_fallbacks']}")
    check(row["billing_sums_ok"], "multi-tenant billing")
    launched = re.findall(r"kernel launches (\{.*\})", log.read_text())
    check(launched, f"the server printed no launch counts: "
                    f"{log.read_text()[-2000:]}")
    launches = json.loads(launched[-1])
    # the server's capsules: the headline's, and the coalesced rows
    caps = [capsule.load(str(p)) for p in sorted(sdir.glob("*.capsule.npz"))]
    check(all(c.seam == "service.solve" for c in caps),
          "service: a server capsule of another seam")
    batched = [c for c in caps if c.static("batched", False)]
    check(batched, f"no coalesced batched dispatch on the card "
                   f"({len(caps)} server capsules, coalesce {row['coalesce']})")
    on_card = [c for c in caps if c.engine == "device"]
    expect = len(on_card)  # compat twice and pack once each
    check(launches.get("compat", 0) >= 2 * expect > 0
          and launches.get("pack", 0) >= expect,
          f"service: the server launched {launches}, its {expect} card "
          f"dispatches need compat twice and pack once each")
    replays = {"batched": 0, "card_ms": 0.0, "cpu_ms": 0.0}
    for c in batched:
        r = replay_both(Path(c.path))
        replays["batched"] += 1
        replays["card_ms"] += r["card_ms"]
        replays["cpu_ms"] += r["cpu_ms"]
    head = max(caps, key=lambda c: int(c.static("max_bins")))
    line["headline"]["capsule"] = replay_both(Path(head.path))
    # one batched dispatch against its rows as single dispatches
    fam: dict = {}
    for c in batched:
        key = tuple(sorted((k, v.shape) for k, v in c.args().items()))
        fam.setdefault((key, c.static("max_bins")), []).append(c)
    rows = max(fam.values(), key=len)[:TENANTS]
    line["batched_vs_single"] = (batched_vs_single(rows, kernels)
                                 if len(rows) >= 2 else None)
    line.update(
        server_launches=launches, server_capsules=len(caps),
        device_capsules=len(on_card), batched_capsules=len(batched),
        batched_replays=replays,
        multitenant={k: row[k] for k in (
            "config", "tenants", "rounds", "total_ms", "single_p99_ms",
            "worst_p99_ms", "p99_ratio", "per_tenant", "coalesce",
            "session_cache", "deltas", "deltas_only_steady_state",
            "isolation_ok", "billing_sums_ok", "client_fallbacks",
            "degraded")})
    return ({"service": line}, {k: launches.get(k, 0)
                                for k in ("compat", "pack")},
            capsule_cases("service", rows[0], kernels))


# ---- the mesh (the tenth main path) ----

# the logical meshes on the one card (one device repeated over the shape,
# so each shard and block runs at a real mesh's shapes): the partitioned
# rung on 1x8 and on 2x4 (the DCN layout's shape), the replicated rung on
# 2x4, the unsharded rung on 1x1; a bin budget under which the headline's
# shards straddle, for the repair bound
MESH_SHAPES = ((1, 8), (2, 4))
MESH_REPL_SHAPE = (2, 4)
MESH_STRADDLE_BINS = 64
# a nodepool limit the headline never reaches: finite, so the partition is
# refused ("nodepool-limits") and the replicated program runs
MESH_LIMIT = 1e18
MESH_OUT = ("assign", "assign_e", "used", "tmpl", "F")


def mesh_phase(args_np, max_bins, level_bits, head_nodes, kernels,
               cuda_kernels, workdir: Path) -> tuple:
    """The mesh (``karpenter_tpu_torch/parallel/mesh.py``) on the card, at
    the headline's kernel arguments, over logical meshes of ``cuda:0``:
    each rung through ``sharded_solve_host`` with compat launches counted
    from 0, one ``mesh.partition`` decision and one ``mesh.solve`` capture
    per call; each rung equal bit for bit to its oracle on the card and on
    the CPU plain path (the partitioned rung to ``partitioned_reference``,
    the others to the unsharded ``solve_step``); each capture written and
    replayed ``exact`` on the card and on the CPU. Returns the
    ``{"mesh": ...}`` line, the path's launches, and the compat cases at
    the shard and block shapes."""
    import torch

    from karpenter_tpu_torch.obs import capsule, decisions
    from karpenter_tpu_torch.ops.tensorize import shard_view
    from karpenter_tpu_torch.parallel import mesh as pmesh

    from karpenter_tpu_torch.models import TorchSolver

    dev = torch.device("cuda")
    Gp = int(args_np["g_count"].shape[0])
    Tp = int(args_np["t_mask"].shape[0])
    total_pods = int(np.asarray(args_np["g_count"]).sum())
    launches = {"compat": 0, "pack": 0}
    # the real mesh counts real cards: on one card it is degenerate and
    # the solver never routes to it
    n_cards = torch.cuda.device_count()
    check(pmesh.make_mesh().devices.size == n_cards,
          f"make_mesh() is not over the {n_cards} card(s)")
    check((TorchSolver()._maybe_mesh() is None) == (n_cards == 1),
          "TorchSolver()._maybe_mesh() does not follow the card count")

    def solve_step_host(args, mb, device):
        out = kernels.solve_step(kernels.from_kernel_args(args, device),
                                 max_bins=mb, level_bits=level_bits)
        return pmesh._to_host(out, MESH_OUT)

    def same(got, want, label):
        for k in MESH_OUT:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            check(a.shape == b.shape and np.array_equal(a, b),
                  f"mesh {label}: {k} differs from its oracle "
                  f"({a.shape} vs {b.shape})")

    def run(label, mesh, args, mb, **knobs):
        """One counted sharded_solve_host: its host dict, rung record and
        capsule path."""
        before = decisions.counts()
        cuda_kernels.reset_launches()
        with CaptureSpy() as spy, env_knobs(**knobs):
            t0 = time.perf_counter()
            host = pmesh.sharded_solve_host(mesh, args, mb,
                                            level_bits=level_bits)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            n = cuda_kernels.LAUNCHES["compat"]
            n_pack = cuda_kernels.LAUNCHES["pack"]
            rec = spy.last.get("mesh.solve")
            path = rec and capsule.write_capsule(
                rec, path=str(workdir / f"mesh-{label}.capsule.npz"),
                why="forced")
        launches["compat"] += n
        launches["pack"] += n_pack
        delta = decisions.rung_delta(before, decisions.counts())
        lr = pmesh.LAST_RUN
        check(spy.counts.get("mesh.solve") == 1 and path,
              f"mesh {label}: {spy.counts} captures, capsule {path}")
        check(delta.get("mesh.partition") == {lr.get("engine"): 1}
              and len(delta) == 1,
              f"mesh {label}: decisions {delta}, not one mesh.partition "
              f"verdict for the {lr.get('engine')} rung")
        used = np.asarray(host["used"])
        row = {"mesh": list(mesh.devices.shape), "max_bins": mb,
               "engine": lr.get("engine"), "reason": lr.get("reason"),
               "n_shards": lr.get("n_shards"), "budget": lr.get("budget"),
               "g_pad": lr.get("g_pad"),
               "balance_ratio": lr.get("balance_ratio"),
               "repaired_pods": lr.get("repaired_pods"),
               "overlap_ms": lr.get("overlap_ms"),
               "shards": lr.get("shards"), "bins": int(used.shape[0]),
               "nodes": int(used.sum()),
               "placed": int(np.asarray(host["assign"]).sum()
                             + np.asarray(host["assign_e"]).sum()),
               "wall_ms": wall_ms, "compat_launches": n,
               "pack_launches": n_pack}
        return host, row, Path(path)

    rows, paths = {}, {}
    ref = {}
    # the partitioned rung, against the sequential oracle of its plan
    for shape in MESH_SHAPES:
        label = "partitioned-" + "x".join(map(str, shape))
        host, row, paths[label] = run(
            label, pmesh.logical_mesh(shape, dev), args_np, max_bins)
        check(row["engine"] == "partitioned",
              f"mesh {label}: the {row['engine']} rung ran ({row['reason']})")
        n = row["n_shards"]
        check(row["compat_launches"] == 2 * n and row["pack_launches"] == n,
              f"mesh {label}: launches compat {row['compat_launches']} and "
              f"pack {row['pack_launches']} != 2 and 1 x {n} shards")
        check(row["placed"] == total_pods,
              f"mesh {label}: placed {row['placed']} of {total_pods} pods")
        for name, device in (("card", dev), ("cpu", "cpu")):
            if (name, n) not in ref:
                t0 = time.perf_counter()
                ref[name, n] = pmesh.partitioned_reference(
                    args_np, max_bins, n, level_bits=level_bits,
                    device=device)
                row[f"oracle_{name}_ms"] = (time.perf_counter() - t0) * 1e3
            same(host, ref[name, n], f"{label} vs the oracle on the {name}")
        rows[label] = row
    base = {name: solve_step_host(args_np, max_bins, device)
            for name, device in (("card", dev), ("cpu", "cpu"))}
    same(base["card"], base["cpu"], "unsharded card vs cpu")
    unsharded_nodes = int(base["card"]["used"].sum())
    # the replicated rung: a finite limit the solve never reaches
    args_lim = dict(args_np, m_limits=np.full_like(
        np.asarray(args_np["m_limits"]), MESH_LIMIT))
    label = "replicated-" + "x".join(map(str, MESH_REPL_SHAPE))
    host, row, paths[label] = run(
        label, pmesh.logical_mesh(MESH_REPL_SHAPE, dev), args_lim, max_bins)
    check((row["engine"], row["reason"]) == ("replicated", "nodepool-limits"),
          f"mesh {label}: {row['engine']}/{row['reason']}")
    n_blocks = MESH_REPL_SHAPE[0] * MESH_REPL_SHAPE[1]
    check(row["compat_launches"] == 2 * n_blocks
          and row["pack_launches"] == 1,
          f"mesh {label}: launches compat {row['compat_launches']} and pack "
          f"{row['pack_launches']} != 2 x {n_blocks} blocks and 1")
    for name, device in (("card", dev), ("cpu", "cpu")):
        same(host, solve_step_host(args_lim, max_bins, device),
             f"{label} vs solve_step on the {name}")
    rows[label] = row
    # the unsharded rung: a degenerate mesh
    label = "unsharded-1x1"
    host, row, paths[label] = run(
        label, pmesh.logical_mesh((1, 1), dev), args_np, max_bins)
    check((row["engine"], row["reason"]) == ("unsharded", "degenerate-mesh"),
          f"mesh {label}: {row['engine']}/{row['reason']}")
    check(row["compat_launches"] == 2 and row["pack_launches"] == 1,
          f"mesh {label}: launches compat {row['compat_launches']} and pack "
          f"{row['pack_launches']} != 2 and 1")
    for name in ("card", "cpu"):
        same(host, base[name], f"{label} vs solve_step on the {name}")
    rows[label] = row
    # the repair bound: straddling shards and no repair allowed
    label = "repair-bound-1x8"
    host, row, paths[label] = run(
        label, pmesh.logical_mesh((1, 8), dev), args_np, MESH_STRADDLE_BINS,
        KARPENTER_SHARD_REPAIR_MAX="0")
    check((row["engine"], row["reason"]) == ("unsharded", "repair-bound"),
          f"mesh {label}: {row['engine']}/{row['reason']}")
    plan = pmesh.plan_shards(args_np, 8, MESH_STRADDLE_BINS)
    check(row["compat_launches"] == 2 * (plan.n_shards + 1)
          and row["pack_launches"] == plan.n_shards + 1,
          f"mesh {label}: launches compat {row['compat_launches']} and pack "
          f"{row['pack_launches']}")
    for name, device in (("card", dev), ("cpu", "cpu")):
        same(host, solve_step_host(args_np, MESH_STRADDLE_BINS, device),
             f"{label} vs solve_step on the {name}")
    rows[label] = row
    # every capture replays exact on the card and on the CPU plain path
    for label, path in paths.items():
        rows[label]["capsule"] = replay_both(path)
    # the partitioned rung's kernels and device time on the card
    mesh18 = pmesh.logical_mesh((1, 8), dev)
    part_trace = device_times(
        lambda: pmesh.sharded_solve(mesh18, args_np, max_bins,
                                    level_bits=level_bits), 1)
    line = {"mesh": {
        "headline_nodes": head_nodes, "unsharded_used": unsharded_nodes,
        "Gp": Gp, "Tp": Tp, "max_bins": max_bins, "rungs": rows,
        "partitioned_1x8_trace": part_trace,
        "compat_launches": launches["compat"]}}
    # compat at the shapes the rungs give it: shard 0 of the 8-shard plan
    # (g_pad rows against the types, the templates, and its budget of
    # bins) and block (0, 0) of the replicated 2x4 mesh
    plan = pmesh.plan_shards(args_np, 8, max_bins)
    lo, hi = plan.bounds[0]
    sh = kernels.from_kernel_args(shard_view(args_np, lo, hi, plan.g_pad),
                                  dev)
    gt = [sh[k] for k in ("g_mask", "g_has", "g_tol",
                          "t_mask", "t_has", "t_tol")]
    gm = gt[:3] + [sh[k] for k in ("m_mask", "m_has", "m_tol")]
    gb, tb = Gp // MESH_REPL_SHAPE[0], Tp // MESH_REPL_SHAPE[1]
    blk = kernels.from_kernel_args(
        {**{k: args_np[k][:gb] for k in ("g_mask", "g_has", "g_tol")},
         **{k: args_np[k][:tb] for k in ("t_mask", "t_has", "t_tol")}}, dev)
    cases = [("mesh GxT", gt), ("mesh GxM", gm),
             ("mesh 1xB", bins_case(sh, hi - lo, plan.budget, kernels)),
             ("replicated GxT", [blk[k] for k in (
                 "g_mask", "g_has", "g_tol", "t_mask", "t_has", "t_tol")])]
    return line, launches, cases


# the dispatch phase: a one-pod-per-node burst whose demand bound sizes
# the bin axis short (about half a node per pod, 1.5x headroom: 2,019
# bins, bucketed to 2,048), so the solve doubles it once (4,038, bucketed
# to 4,096, the cap); and the selector mix of
# tests/test_partitioned_mesh.py, whose bins host several groups
BURST_PODS = 2_600
BURST_BP2 = 4_096
BURST_PAIRS = 3
SKIP_MIX_PODS = 96
# the exact fit: 2,400 pods of 5.2 cpu (one per node) and 1,880 of 0.1 cpu
# that fill the gaps, on the burst's type; the demand bound is 1,600 nodes
# (12,668 cpu over 7.92 allocatable), so the axis is 2,400, every bin is
# used and no pod is left over: the doubled axis (4,096, the burst's family)
# is dispatched and not needed
FIT_BIG, FIT_SMALL = 2_400, 1_880


def one_per_node(n: int) -> tuple:
    """n pods of 4.1 cpu on one 8-cpu type (``tests/test_torch_solver.py``'s
    ``_one_per_node``): one pod per node."""
    from karpenter_tpu_torch.api.nodepool import NodePool
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_tpu_torch.cloudprovider.catalog import make_instance_type
    from karpenter_tpu_torch.models.inflight import ClaimTemplate

    pods = [Pod(metadata=ObjectMeta(name=f"w{i}"),
                requests={"cpu": 4.1, "memory": 2**30}) for i in range(n)]
    pool = NodePool(metadata=ObjectMeta(name="default"))
    return pods, [ClaimTemplate(pool)], {
        "default": [make_instance_type("big", 8, 32)]}


def exact_fit(big: int, small: int) -> tuple:
    """``big`` pods of 5.2 cpu and ``small`` pods of 0.1 cpu on
    ``one_per_node``'s type: one big pod per node, the small ones in the
    gaps."""
    from karpenter_tpu_torch.api.nodepool import NodePool
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_tpu_torch.cloudprovider.catalog import make_instance_type
    from karpenter_tpu_torch.models.inflight import ClaimTemplate

    pods = [Pod(metadata=ObjectMeta(name=f"b{i}"),
                requests={"cpu": 5.2, "memory": 2**30}) for i in range(big)]
    pods += [Pod(metadata=ObjectMeta(name=f"s{i}"),
                 requests={"cpu": 0.1, "memory": 2**20}) for i in range(small)]
    pool = NodePool(metadata=ObjectMeta(name="default"))
    return pods, [ClaimTemplate(pool)], {
        "default": [make_instance_type("big", 8, 32)]}


def solve_cases(label, inputs, solver, Bps, kernels) -> list:
    """The compat products a solve of ``inputs`` launches on the card at
    its plan's Gp, Tp: G×T, G×M and a 1×Bp for each bin axis in ``Bps``."""
    import torch

    from karpenter_tpu_torch.ops.tensorize import kernel_args, tensorize

    snap = tensorize(*inputs)
    plan = solver.plan(snap)
    args = kernels.from_kernel_args(
        kernel_args(snap, Gp=plan["Gp"], Tp=plan["Tp"]), torch.device("cuda"))
    gt = [args[k] for k in ("g_mask", "g_has", "g_tol",
                            "t_mask", "t_has", "t_tol")]
    return [(f"{label} GxT", gt),
            (f"{label} GxM",
             gt[:3] + [args[k] for k in ("m_mask", "m_has", "m_tol")]),
            *((f"{label} 1x{Bp}", bins_case(args, snap.G, Bp, kernels))
              for Bp in Bps)]


def selector_mix(n: int) -> tuple:
    """``tests/test_torch_solver.py``'s ``selector_mix``: n pods of four
    sizes under no selector or one of two arch selectors, over fresh
    ``benchmark_catalog(24)`` objects."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.nodepool import NodePool
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_tpu_torch.cloudprovider.catalog import benchmark_catalog
    from karpenter_tpu_torch.models.inflight import ClaimTemplate

    sizes = [(0.25, 0.5), (0.5, 1.0), (0.75, 1.5), (1.0, 2.0)]
    sels = [{}, {wk.ARCH_LABEL: "amd64"}, {wk.ARCH_LABEL: "arm64"}]
    pods = [Pod(metadata=ObjectMeta(name=f"p{i}"),
                requests={"cpu": sizes[i % 4][0],
                          "memory": sizes[i % 4][1] * 2**30},
                node_selector=dict(sels[i % 3])) for i in range(n)]
    pool = NodePool(metadata=ObjectMeta(name="default"))
    return pods, [ClaimTemplate(pool)], {"default": benchmark_catalog(24)}


def claims_of(res) -> list:
    """A result's claims in order: pool, pod names, instance-type names."""
    return [(c.template.nodepool_name, sorted(p.name for p in c.pods),
             sorted(it.name for it in c.instance_types))
            for c in res.new_claims]


def decided(solver, inputs) -> dict:
    """One solve: its ``decode.recheck`` verdicts, exact skips, claims,
    decode ms and wall ms."""
    import torch

    from karpenter_tpu_torch.obs import decisions
    from karpenter_tpu_torch.ops.tensorize import STATS

    c0, s0 = decisions.counts(), STATS["decode_exact_skips"]
    t0 = time.perf_counter()
    res = solver.solve(*inputs)
    if solver.device.type == "cuda":
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    verdicts = {}
    for (site, rung, reason), n in decisions.counts().items():
        d = n - c0.get((site, rung, reason), 0)
        if site == "decode.recheck" and d:
            verdicts[f"{rung}/{reason}"] = d
    return {"verdicts": verdicts,
            "exact_skips": STATS["decode_exact_skips"] - s0,
            "claims": claims_of(res), "nodes": res.node_count(),
            "decode_ms": solver.last_device_stats["decode_ms"],
            "bins": solver.last_device_stats["bins"],
            "Gp": solver.last_device_stats["Gp"], "wall_ms": wall_ms}


def dispatch_phase(solver, pods, templates, its, step_kernels, kernels,
                   cuda_kernels, workdir: Path) -> tuple:
    """The three pieces of the solve's dispatch path on the card, with
    routing off: the headline under ``KARPENTER_PROFILE_DIR`` (one Chrome
    trace, holding CUDA kernel events, compat's symbol twice and the pack
    kernel's once per dispatch;
    the claims of an unprofiled solve of the same batch); the
    one-pod-per-node burst on one ``TorchSolver()`` (``KARPENTER_RELAX=0``,
    so the estimate is the demand bound and runs dry once), in
    ``BURST_PAIRS`` pairs of a cold solve (the doubled family forgotten
    first: the doubled dispatch is deferred) and a warm one (it
    speculates once, ``solve.dispatch_spec``), alternating which runs
    first; every solve grows once, launches compat 2 x 2 and pack 2 times
    and equals ``TorchSolver(device="cpu")``'s claims; the exact fit
    (``exact_fit``) in as many pairs: its axis runs dry with no pod left
    over, so the warm leg's speculation is thrown away (two dispatches)
    and the cold leg dispatches once; and
    ``KARPENTER_DECODE_EXACT_SKIP`` at 0 and 1 over the selector mix and
    the headline, fresh objects per solve, card = CPU in verdicts, exact
    skips and claims. Returns the ``{"dispatch": ...}`` line, the path's
    launches and the compat cases of the burst, the exact fit and the mix
    at the shapes their solves launch."""
    import torch

    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.models import solver as msolver
    from karpenter_tpu_torch.ops.tensorize import tensorize
    from karpenter_tpu_torch.workload import build_workload

    launches = {"compat": 0, "pack": 0}

    def counted(fn):
        """fn's result and its (compat, pack) launches"""
        cuda_kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for k in launches:
            launches[k] += cuda_kernels.LAUNCHES[k]
        return out, (cuda_kernels.LAUNCHES["compat"],
                     cuda_kernels.LAUNCHES["pack"])

    # ---- the headline under the profiler ----
    def headline():
        t0 = time.perf_counter()
        res = solver.solve([p.clone() for p in pods], templates, its)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    (res0, plain_ms), _ = counted(headline)
    st = solver.last_device_stats
    n_dispatch = 1 + st.get("bin_growths", 0)
    expected = (2 * n_dispatch, n_dispatch)  # compat, pack
    attempts = []
    for attempt in range(3):
        # a trace can come back without the ctypes-launched kernel's
        # records (seen in device_times): taken again, up to three times
        directory = workdir / f"profile-{attempt}"
        with env_knobs(KARPENTER_PROFILE_DIR=str(directory)):
            (res, prof_ms), n_launched = counted(headline)
        traces = sorted(directory.glob("*.pt.trace.json"))
        check(len(traces) == n_dispatch,
              f"dispatch: {len(traces)} traces for {n_dispatch} dispatches")
        events = [ev for path in traces
                  for ev in json.loads(path.read_text())["traceEvents"]]
        kern = [ev for ev in events if ev.get("cat") == "kernel"]
        in_trace = (
            sum("compat_kernel" in ev.get("name", "") for ev in kern),
            sum("pack_kernel" in ev.get("name", "") for ev in kern))
        attempts.append({"wall_ms": prof_ms, "events": len(events),
                         "kernel_events": len(kern),
                         "compat_in_trace": in_trace[0],
                         "pack_in_trace": in_trace[1],
                         "compat_launches": n_launched[0],
                         "pack_launches": n_launched[1],
                         "trace_bytes": sum(p.stat().st_size
                                            for p in traces)})
        check(n_launched == expected,
              f"dispatch: profiled headline launches (compat, pack) "
              f"{n_launched} != {expected}")
        check(claims_of(res) == claims_of(res0),
              "dispatch: the profiled headline's claims differ")
        if in_trace == expected:
            break
    check(kern, "dispatch: the profiled headline's trace holds no CUDA "
                "kernel event")
    check(in_trace == expected,
          f"dispatch: (compat, pack) in the trace "
          f"{[(a['compat_in_trace'], a['pack_in_trace']) for a in attempts]}"
          f" != 2 and 1 per dispatch ({expected})")
    profiled = {"plain_wall_ms": plain_ms, "attempts": attempts,
                "solve_step_trace_kernels": step_kernels,
                "nodes": res0.node_count(), "compat_expected": expected}

    # ---- the growth burst: cold (deferred) and warm (speculated) ----
    # in BURST_PAIRS pairs, alternating which leg runs first; a cold leg
    # forgets the doubled family first
    burst = {"cold": [], "warm": []}
    saved = set(msolver._WARM_FAMILIES)
    msolver._WARM_FAMILIES.clear()
    with env_knobs(KARPENTER_RELAX="0"):
        card = TorchSolver()
        cpu = TorchSolver(device="cpu")
        want = claims_of(cpu.solve(*one_per_node(BURST_PODS)))
        check(cpu.last_device_stats.get("bin_growths") == 1,
              "dispatch: the CPU burst did not grow once")
        for i in range(BURST_PAIRS):
            for leg in (("cold", "warm") if i % 2 == 0 else ("warm", "cold")):
                if leg == "cold":
                    msolver._WARM_FAMILIES.difference_update(
                        {k for k in msolver._WARM_FAMILIES
                         if k[0] == BURST_BP2})
                batch = one_per_node(BURST_PODS)
                t0 = time.perf_counter()
                with obs.round_trace("dispatch") as tr:
                    res, n_launched = counted(lambda: card.solve(*batch))
                wall_ms = (time.perf_counter() - t0) * 1e3
                st = dict(card.last_device_stats)
                spec = [sp.dur * 1e3 for sp in tr.spans()
                        if sp.name == "solve.dispatch_spec"]
                check(st.get("bin_growths") == 1 and st["engine"] == "cuda"
                      and st["bins"] == BURST_BP2,
                      f"dispatch: the {leg} burst did not grow once to "
                      f"{BURST_BP2} bins on the card: {st}")
                check(len(spec) == (leg == "warm"),
                      f"dispatch: the {leg} burst opened {len(spec)} "
                      "solve.dispatch_spec spans")
                check(n_launched == (4, 2),
                      f"dispatch: the {leg} burst launched (compat, pack) "
                      f"{n_launched}, not (4, 2): two dispatches")
                check(res.scheduled_pod_count() == BURST_PODS
                      and claims_of(res) == want,
                      f"dispatch: the {leg} burst's claims differ from the "
                      "CPU's")
                burst[leg].append({
                    "wall_ms": wall_ms, "solve_ms": st["solve_ms"],
                    "decode_ms": st["decode_ms"], "spec_ms": spec,
                    "compat_launches": n_launched[0],
                    "pack_launches": n_launched[1]})
        burst.update(nodes=len(want), B=st["B"], bins=st["bins"],
                     Gp=st["Gp"])
        for leg in ("cold", "warm"):
            for key in ("wall_ms", "solve_ms", "decode_ms"):
                burst[f"{leg}_median_{key}"] = statistics.median(
                    r[key] for r in burst[leg])
        # the doubled family as the burst's dispatches left it warm
        warm = {k for k in msolver._WARM_FAMILIES if k[0] == BURST_BP2}
        check(warm, "dispatch: the burst left its doubled family cold")
        # the burst's compat products at both of its axes
        first_bp = card.plan(tensorize(*one_per_node(BURST_PODS)))["Bp"]
        cases = solve_cases("dispatch burst", one_per_node(BURST_PODS), card,
                            (first_bp, BURST_BP2), kernels)

        # ---- the exact fit: a speculation the decode does not need ----
        # the warm leg launches the doubled axis and throws it away; the
        # cold leg defers it and never dispatches it
        fit = {"cold": [], "warm": []}
        want = claims_of(cpu.solve(*exact_fit(FIT_BIG, FIT_SMALL)))
        for i in range(BURST_PAIRS):
            for leg in (("cold", "warm") if i % 2 == 0 else ("warm", "cold")):
                if leg == "cold":
                    msolver._WARM_FAMILIES.difference_update(
                        {k for k in msolver._WARM_FAMILIES
                         if k[0] == BURST_BP2})
                else:
                    msolver._WARM_FAMILIES.update(warm)
                batch = exact_fit(FIT_BIG, FIT_SMALL)
                t0 = time.perf_counter()
                with obs.round_trace("dispatch") as tr:
                    res, n_launched = counted(lambda: card.solve(*batch))
                wall_ms = (time.perf_counter() - t0) * 1e3
                st = dict(card.last_device_stats)
                spec = [sp.dur * 1e3 for sp in tr.spans()
                        if sp.name == "solve.dispatch_spec"]
                check(not st.get("bin_growths") and st["engine"] == "cuda"
                      and st["B"] == FIT_BIG,
                      f"dispatch: the {leg} exact fit grew or left its "
                      f"{FIT_BIG}-bin axis: {st}")
                check(len(spec) == (leg == "warm"),
                      f"dispatch: the {leg} exact fit opened {len(spec)} "
                      "solve.dispatch_spec spans")
                n_dispatch = 1 + (leg == "warm")
                check(n_launched == (2 * n_dispatch, n_dispatch),
                      f"dispatch: the {leg} exact fit launched (compat, "
                      f"pack) {n_launched} in {n_dispatch} dispatches")
                check(claims_of(res) == want and res.node_count() == FIT_BIG,
                      f"dispatch: the {leg} exact fit's claims differ from "
                      "the CPU's")
                fit[leg].append({
                    "wall_ms": wall_ms, "solve_ms": st["solve_ms"],
                    "decode_ms": st["decode_ms"], "spec_ms": spec,
                    "compat_launches": n_launched[0],
                    "pack_launches": n_launched[1]})
        fit.update(nodes=len(want), B=st["B"], bins=st["bins"], Gp=st["Gp"])
        for leg in ("cold", "warm"):
            for key in ("wall_ms", "solve_ms", "decode_ms"):
                fit[f"{leg}_median_{key}"] = statistics.median(
                    r[key] for r in fit[leg])
        cases += solve_cases("dispatch fit", exact_fit(FIT_BIG, FIT_SMALL),
                             card, (st["bins"], BURST_BP2), kernels)
    msolver._WARM_FAMILIES.clear()
    msolver._WARM_FAMILIES.update(saved)

    # ---- the exact-skip knob at 0 and 1, card = CPU ----
    arms = {}
    with env_knobs(KARPENTER_RELAX="0"):
        for knob in ("0", "1"):
            with env_knobs(KARPENTER_DECODE_EXACT_SKIP=knob):
                for name, build in (
                        ("mix", lambda: selector_mix(SKIP_MIX_PODS)),
                        ("headline", lambda: build_workload(N_PODS, N_TYPES))):
                    on_card, _ = counted(lambda: decided(TorchSolver(),
                                                         build()))
                    on_cpu = decided(TorchSolver(device="cpu"), build())
                    for key in ("verdicts", "exact_skips", "claims"):
                        check(on_card[key] == on_cpu[key],
                              f"dispatch: {name} at exact-skip {knob}: "
                              f"{key} card != CPU")
                    # at 0 the mix's multi-group bins take the merged
                    # re-check; at 1 no bin does for want of the knob
                    disabled = on_card["verdicts"].get("full/disabled", 0)
                    check(disabled > 0 if knob == "0" and name == "mix"
                          else knob == "0" or disabled == 0,
                          f"dispatch: {name} at exact-skip {knob}: "
                          f"verdicts {on_card['verdicts']}")
                    arms[f"{name}@{knob}"] = {
                        "verdicts": on_card["verdicts"],
                        "exact_skips": on_card["exact_skips"],
                        "nodes": on_card["nodes"],
                        "decode_ms": on_card["decode_ms"],
                        "cpu_decode_ms": on_cpu["decode_ms"],
                        "wall_ms": on_card["wall_ms"],
                        "bins": on_card["bins"], "Gp": on_card["Gp"]}
        # the mix's compat products at the shapes its solves launch: G×T,
        # G×M and 1×Bp over its own catalog (the headline's are main's)
        shape = {(arms[f"mix@{knob}"]["bins"], arms[f"mix@{knob}"]["Gp"])
                 for knob in ("0", "1")}
        check(len(shape) == 1, f"dispatch: the mix's Bp, Gp differ between "
                               f"the exact-skip arms: {shape}")
        mix_bp, mix_gp = shape.pop()
        mix = TorchSolver()
        plan = mix.plan(tensorize(*selector_mix(SKIP_MIX_PODS)))
        check(plan["Gp"] == mix_gp, f"dispatch: the mix's plan pads G to "
                                    f"{plan['Gp']}, its solves to {mix_gp}")
        cases += solve_cases("dispatch mix", selector_mix(SKIP_MIX_PODS), mix,
                             (mix_bp,), kernels)
    return ({"dispatch": {"profiled_headline": profiled, "burst": burst,
                          "exact_fit": fit, "exact_skip": arms,
                          "compat_launches": launches["compat"]}},
            launches, cases)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.ops import cuda_kernels, kernels, relax
    from karpenter_tpu_torch.ops.tensorize import kernel_args, tensorize
    from karpenter_tpu_torch.utils import resources as resutil
    from karpenter_tpu_torch.workload import build_workload

    import os
    import tempfile

    from karpenter_tpu_torch import obs

    t_script = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    # the flight recorder dumps anomalous rounds' Chrome traces here
    trace_tmp = tempfile.TemporaryDirectory(prefix="karpenter-traces-")
    trace_dir = Path(trace_tmp.name)
    os.environ["KARPENTER_TRACE_DIR"] = str(trace_dir)
    os.environ.pop("KARPENTER_TRACE", None)
    obs.reset()

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
    # every phase up to spot keeps the device path (routing off)
    pin = pinned().__enter__()
    t_headline = time.perf_counter()
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
    check(launches["compat"] == 2 * n_dispatch
          and launches["pack"] == n_dispatch,
          f"launches {launches} != compat 2 and pack 1 per dispatch over "
          f"{n_dispatch} dispatches")
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

    # the tracer on and off at the headline (the obs phase's first part)
    t0 = time.perf_counter()
    obs_head = obs_headline(solver, pods2, templates2, its2, cuda_kernels)
    obs_head["phase_s"] = time.perf_counter() - t0

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
    HANDOFF["headline"] = (args_gpu, step_kw)
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

    # the multiply-add tie, on the card and on the CPU plain path
    tie = tie_check(kernels)

    headline_s = time.perf_counter() - t_headline

    # ---- the eleventh main path: the solve's dispatch path ----
    # right after the headline: late in a process that has profiled for
    # minutes, CUPTI drops records (the G×T compat launch missing from
    # three traces in a row, seen), and the phase counts compat's records
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        disp_line, disp_launches, disp_cases = dispatch_phase(
            solver, pods2, templates2, its2, step_trace and
            step_trace["kernels"], kernels, cuda_kernels, Path(workdir))
        disp_line["dispatch"]["phase_s"] = time.perf_counter() - t0

    # ---- the second main path: the live round on the headline's cluster ----
    t0 = time.perf_counter()
    live_line, live_cases, live_launches, live_trace = live_round_phase(
        res.new_claims, templates, its, cuda_kernels, kernels)
    live_line["live_round"]["phase_s"] = time.perf_counter() - t0

    # ---- the third main path: the consolidation probe ----
    t0 = time.perf_counter()
    cons_line, cons_cases, cons_launches = consolidation_phase(
        cuda_kernels, kernels)
    cons_line["consolidation"]["phase_s"] = time.perf_counter() - t0

    # ---- the fourth main path: the operator loop ----
    t0 = time.perf_counter()
    op_line, op_launches, op_cases = operator_phase(cuda_kernels, kernels)
    op_line["operator"]["phase_s"] = time.perf_counter() - t0

    # ---- the fifth main path: the admission plane ----
    t0 = time.perf_counter()
    adm_line, adm_launches, adm_cases = admission_phase(cuda_kernels,
                                                        kernels)
    adm_line["admission"]["phase_s"] = time.perf_counter() - t0

    # ---- the sixth main path: the spot storm's interruption path ----
    t0 = time.perf_counter()
    spot_line, spot_launches, spot_cases = spot_phase(cuda_kernels, kernels)
    spot_line["spot"]["phase_s"] = time.perf_counter() - t0
    pin.__exit__(None, None, None)

    # ---- the seventh main path: the engine ladder and the entry point ----
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        eng_line, eng_launches = engines_phase(kernels, cuda_kernels,
                                               Path(workdir))
    eng_line["engines"]["phase_s"] = time.perf_counter() - t0

    # ---- the observability planes, from the captures above ----
    t0 = time.perf_counter()
    obs_line = obs_phase(card, trace_dir, obs_head)
    obs_line["obs"]["phase_s"] = time.perf_counter() - t0

    # ---- the ninth main path: replay capsules and the solver service ----
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        cap_line, cap_launches, cap_cases = capsule_phase(
            cuda_kernels, kernels, Path(workdir))
        cap_line["capsule"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc_line, svc_launches, svc_cases = service_phase(kernels,
                                                          Path(workdir))
        svc_line["service"]["phase_s"] = time.perf_counter() - t0

    # ---- the tenth main path: the mesh, over logical meshes of the card ----
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        mesh_line, mesh_launches, mesh_cases = mesh_phase(
            args_np, Bp, plan["level_bits"], res.node_count(), kernels,
            cuda_kernels, Path(workdir))
        mesh_line["mesh"]["phase_s"] = time.perf_counter() - t0

    # ---- every kernel against its plain version, on the card ----
    _, K, W = args_gpu["g_mask"].shape
    gt_in = [args_gpu[k] for k in ("g_mask", "g_has", "g_tol",
                                   "t_mask", "t_has", "t_tol")]
    gm_in = gt_in[:3] + [args_gpu[k] for k in ("m_mask", "m_has", "m_tol")]
    rng = np.random.default_rng(0)
    timed = [("main GxT", gt_in), ("main GxM", gm_in),
             ("main 1xB", bins_case(args_gpu, snap.G, Bp, kernels)),
             *live_cases, *cons_cases, *op_cases, *adm_cases, *spot_cases,
             *cap_cases, *svc_cases, *mesh_cases, *disp_cases,
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
    pack_shapes = pack_cells(kernels, cuda_kernels)
    live_trace()
    main_gt = shapes[0]
    pack_paths = {
        path: got["pack"] for path, got in (
            ("headline", launches), ("live_round", live_launches),
            ("consolidation", cons_launches), ("operator", op_launches),
            ("admission", adm_launches), ("spot", spot_launches),
            ("engines", eng_launches), ("capsule", cap_launches),
            ("service", svc_launches), ("mesh", mesh_launches),
            ("dispatch", disp_launches))}
    pack_paths["obs"] = obs_head["pack_launches"]
    kernels_line = {"kernels": [{
        "name": "compat",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/compat.cu",
        "replaces": "karpenter_tpu/ops/pallas_kernels.py:62",
        "launches": (launches["compat"] + live_launches["compat"]
                     + cons_launches["compat"] + op_launches["compat"]
                     + adm_launches["compat"] + spot_launches["compat"]
                     + eng_launches["compat"] + obs_head["compat_launches"]
                     + cap_launches["compat"] + svc_launches["compat"]
                     + mesh_launches["compat"] + disp_launches["compat"]),
        "launches_by_path": {"headline": launches["compat"],
                             "live_round": live_launches["compat"],
                             "consolidation": cons_launches["compat"],
                             "operator": op_launches["compat"],
                             "admission": adm_launches["compat"],
                             "spot": spot_launches["compat"],
                             "engines": eng_launches["compat"],
                             "obs": obs_head["compat_launches"],
                             "capsule": cap_launches["compat"],
                             "service": svc_launches["compat"],
                             "mesh": mesh_launches["compat"],
                             "dispatch": disp_launches["compat"]},
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
    }, {
        "name": "pack",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/pack.cu",
        "replaces": "no Pallas kernel: the lax.scan of "
                    "karpenter_tpu/ops/kernels.py pack",
        "launches": sum(pack_paths.values()),
        "launches_by_path": pack_paths,
        "tolerance": "exact (every output bit-equal to pack_reference)",
        "ms": pack_shapes[0]["ms"],
        "device_ms": pack_shapes[0]["device_ms"],
        "plain_ms": pack_shapes[0]["plain_ms"],
        "bound_ms": pack_shapes[0]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shapes": pack_shapes,
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
        "tie": tie,
        "build_s": build_s, "phase_s": headline_s,
    }}
    print(json.dumps(kernels_line))
    live_line["live_round"]["script_s"] = time.perf_counter() - t_script
    print(json.dumps(solve_line))
    print(json.dumps(live_line))
    print(json.dumps(cons_line))
    print(json.dumps(op_line))
    print(json.dumps(adm_line))
    print(json.dumps(spot_line))
    print(json.dumps(eng_line))
    print(json.dumps(obs_line))
    print(json.dumps(cap_line))
    print(json.dumps(svc_line))
    mesh_line["mesh"]["script_s"] = time.perf_counter() - t_script
    print(json.dumps(mesh_line))
    disp_line["dispatch"]["script_s"] = time.perf_counter() - t_script
    print(json.dumps(disp_line))
    trace_tmp.cleanup()
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def full_storm(n_nodes: int) -> int:
    """``python3 chip_smoke.py --full-storm [N]``: the storm at
    ``perf/run.py``'s size (``spot_storm(N)``, N 1,000 by default) with
    the engine ladder at its default gates, both legs on ``TorchSolver()``
    with ``KARPENTER_RELAX=1``, outside the smoke run (it outlasts its
    time limit). Prints the time and solver calls at each round's start,
    each leg's counts, engines and times, then the three gates."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from karpenter_tpu_torch.cloudprovider import chaos
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.ops import consolidate as cons
    from karpenter_tpu_torch.ops import cuda_kernels, kernels
    from karpenter_tpu_torch.workload import spot_gates

    print("card:", card_line(), flush=True)
    cuda_kernels.build()
    calls = {"n": 0, "ms": 0.0}
    real_solve = TorchSolver.solve

    def solve(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return real_solve(self, *a, **kw)
        finally:
            calls["n"] += 1
            calls["ms"] += (time.perf_counter() - t0) * 1e3

    real_storm = chaos.ChaosCloud.notice_storm
    t_leg = [0.0]

    def notice_storm(self, *a, **kw):
        print(f"  round start t={time.perf_counter() - t_leg[0]:.1f}s "
              f"solves={calls['n']} solve_s={calls['ms'] / 1e3:.1f}",
              flush=True)
        return real_storm(self, *a, **kw)

    TorchSolver.solve = solve
    chaos.ChaosCloud.notice_storm = notice_storm
    legs = {}
    t_all = time.perf_counter()
    with env_knobs(KARPENTER_RELAX="1"):
        for name in ("risk_aware", "risk_blind"):
            t_leg[0] = time.perf_counter()
            calls.update(n=0, ms=0.0)
            print(name, "start", flush=True)
            leg = spot_leg(None, kernels, cuda_kernels, cons,
                           SPOT_EXPECT[name]["lam"], n_nodes)
            legs[name] = leg
            out = {k: v for k, v in leg.items()
                   if k not in ("commands", "last_absorb", "last_step")}
            out["seconds"] = time.perf_counter() - t_leg[0]
            print(json.dumps({name: out}), flush=True)
    print(json.dumps({"gates": spot_gates(legs["risk_aware"],
                                          legs["risk_blind"], n_nodes),
                      "total_s": time.perf_counter() - t_all}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--full-storm"]:
        sys.exit(full_storm(int(sys.argv[2]) if len(sys.argv) > 2
                            else SPOT_NODES_FULL))
    sys.exit(main())
