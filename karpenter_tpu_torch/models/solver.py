"""Solver: the device/host boundary of the port.

``TorchSolver`` is the port of ``karpenter_tpu.models.solver.TPUSolver``
for one provisioning round: it compiles the snapshot to tensors
(``ops.tensorize``; with a topology, through the waves compiler
``ops.waves`` first), compiles the cluster's existing nodes into phase A's
pre-loaded bins (``tensorize_existing``), runs feasibility + pack on the
device (``ops.kernels.solve_step``, whose requirement-compat products are
the CUDA kernel of ``ops.cuda_kernels``), reads the outputs back as ONE
int32 buffer, and decodes bins into in-flight NodeClaims and existing-node
placements validated on the host. Pods the device path cannot express,
and leftovers, go through ``HostSolver`` — the FFD loop — seeded with the
device-built claims, the updated existing nodes and the topology, as in
the JAX package; that route is part of the semantics.

Stages covered, as in ``TPUSolver.solve``/``_run_and_decode``/``_unpack``/
``_decode``/``_compat_entry``/``_decomposable``: device eligibility, the
waves compile and its host-routed reasons, tensorize, the bin-axis
estimate (demand, topology-class and LP-floor lower bounds,
``ops/relax.py``) and ``level_bits``, the doubling re-run while bins run
dry (a plain synchronous re-run), the single-buffer read back, the host
decode, the existing-node and topology commits and the nodepool-limit
debit before the host pass, and ``existing_base=``: a confirming
simulation's existing-node tensors sliced out of the disruption round's
snapshot (``DisruptionSnapshot.derive_esnap``) instead of re-tensorized.

``tier_of=`` (the fused admission round, ``admission/plane.py``) splits
the signature groups by priority tier and orders the scan tier-major, as
the JAX package does; the waves path ignores it.

The engine ladder (``TPUSolver``'s routing by size): a batch of at most
``HOST_CUTOFF_PODS`` pods runs the host FFD loop without tensorizing; a
dispatch of at most ``NATIVE_CUTOFF_PODS`` pods, or with fewer than
``DEVICE_MIN_WORK`` real group×type cells, or on a solver whose device is
not an accelerator, runs the native C++ engine (``karpenter_tpu_torch/
native``) on the numpy arguments and never uploads them; the rest goes to
the device. ``KARPENTER_NATIVE_CUTOFF=0`` turns all routing off,
``KARPENTER_HOST_CUTOFF`` and ``KARPENTER_DEVICE_MIN_WORK`` move the other
two gates, and ``KARPENTER_ASSUME_ACCELERATOR`` overrides the device test.
``last_device_stats`` records the ``engine`` that ran (``"host"``,
``"native"`` or the device type); each solve records ONE ``solver.route``
decision, its (rung, reason) also kept on ``_route`` as the JAX package
keeps it. ``NativeSolver`` always runs the native engine; ``make_solver``
picks the default solver.

Observability, at the JAX package's sites and with its names: the
``solve.host`` span around the FFD loop; per dispatch ``solve.kernel``
(``device``) holding ``solve.native`` or ``solve.dispatch`` (the eager
launch of the pack loop) and ``solve.block`` (the one readback, where
the host waits for the card), then ``solve.decode``; the compile ledger's
``solve.kernel`` family under the JAX package's key (padded shapes and
static parameters), the ``solve.bins`` padding site, the bin-growth
counter, the solve-quality account and the ``decode.recheck`` decision.
``last_device_stats`` carries the solve's ``cold_compiles`` and
``pad_waste_ratio`` deltas. The port's own layer spans, which the JAX
package does not open, cover the rest of a device-path solve:
``solve.classify`` (the eligibility split), ``solve.plan`` (the bin-axis
estimate, holding the LP floor's ``relax.inputs`` and ``relax.floor``)
and ``solve.commit`` (the stats and the commits before the host pass);
``solve.dispatch`` and ``solve.dispatch_spec`` carry ``Gp``, ``Bp``,
``level_bits`` and ``pack``: ``kernel`` where the pack loop is one launch
of ``csrc/pack.cu`` (CUDA), ``plain`` where it is ``pack_reference``
(the CPU). No span encloses the whole solve, so a round's time
outside its spans is what no layer accounts for.

Every dispatch records a replay capture (``obs/capsule.py``, seam
``solver.invoke``): the numpy kernel arguments, the host outputs, the
engine and route, and the static parameters, with the JAX package's
field names (``pallas`` is always False here). ``_dispatch`` is the one
numpy-level dispatch both ``_run_and_decode`` and the solver service's
server go through, so a served solve routes exactly as an in-process
one; ``RemoteSolver`` (service/solver_service.py) overrides it to ship
the numpy arguments instead. ``batched_invoke`` is the service's
coalesced dispatch: N same-shape snapshots in one dispatch on the card.
The engine and route of the last dispatch are thread-local, as in the
JAX package: the service drives one shared solver from concurrent
threads.

The mesh route (``parallel/mesh.py``): on a solver whose device is CUDA
with more than one card attached, a dispatch whose feasibility work
``G·T·K·W`` reaches ``SHARD_MIN_WORK`` goes through
``sharded_solve_host`` (engine ``mesh``, route ``("mesh", "ok")``), which
records its own ``mesh.solve`` capture, so the ``solver.invoke`` capture is
skipped there and one dispatch yields one capsule. On one card the mesh
is degenerate and never taken.

The doubling re-run is speculative where the JAX package's is
(``_invoke_spec``): when a dispatch exhausts its bin axis, the doubled
axis is queued on the card before the decode, inside
``solve.dispatch_spec``, if its ``(Bp, level_bits, max_minv)`` family has
been dispatched on the device before in this process (``_WARM_FAMILIES``,
the counterpart of the JAX package's jit-wrapper cache), the last
dispatch took the device rung, there is no mesh and no profile is being
taken; the next ``solve.kernel`` then holds only its readback. Otherwise
the re-run is deferred until the decode asks for it and goes through
``_dispatch`` again.

``KARPENTER_PROFILE_DIR`` wraps every dispatch that leaves the native
engine (the mesh call, or the upload and ``_invoke``) in
``torch.profiler`` and writes one Chrome trace per dispatch into that
directory (``_profiled``), as the JAX package's ``jax.profiler.trace``
does. ``KARPENTER_DECODE_EXACT_SKIP=0`` turns the decoder's multi-group
exact-skip off (``_exact_skip_enabled``).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import socket
import threading
import time

import numpy as np
import torch

from karpenter_tpu_torch import native, obs
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.models.inflight import InFlightNodeClaim
from karpenter_tpu_torch.obs import capsule, decisions, devplane
from karpenter_tpu_torch.models.scheduler import (
    NullTopology,
    Scheduler,
    SchedulerResults,
    subtract_max,
)
from karpenter_tpu_torch.ops import kernels, waves
from karpenter_tpu_torch.ops.cuda_kernels import DEVICE_FAULTS
from karpenter_tpu_torch.ops.relax import lp_bin_floor
from karpenter_tpu_torch.ops.tensorize import (
    _COMPAT_CACHE_MAX,
    SPREAD_OWNED_MIN,
    STATS as _TZ_STATS,
    bucket as _bucket,
    device_basic_eligible,
    device_eligible,
    group_by_signature,
    kernel_args,
    tensorize,
    tensorize_existing,
)
from karpenter_tpu_torch.utils import resources as resutil
from karpenter_tpu_torch.utils.envknobs import env_bool, env_int, env_str

# The JAX package's cutoffs (karpenter_tpu/models/solver.py), kept as they
# are: pods per solve at or below which the native engine runs instead of
# the device (0 turns ALL routing off); pods per batch at or below which
# the host FFD loop runs without tensorizing; real group×type cells below
# which a batch is a short sequential loop the native engine finishes
# first (0 turns this gate off).
NATIVE_CUTOFF_PODS = 192
HOST_CUTOFF_PODS = 8
DEVICE_MIN_WORK = 8192
# feasibility work (G*T*K*W mask cells) above which a multi-device mesh
# earns its overhead; single-card installs never shard
SHARD_MIN_WORK = 1 << 21


def capture_engine(engine: str) -> str:
    """A dispatch's engine as a replay capture names it, in the JAX
    package's words: ``native`` and ``remote`` as they are, the device
    types (``cuda``, ``cpu``) as ``device``."""
    return engine if engine in ("native", "remote") else "device"


def _native_cutoff() -> int:
    """The routing master switch: 0 turns ALL engine routing off (the
    parity tests pin this to keep the device path under test)."""
    return env_int("KARPENTER_NATIVE_CUTOFF", NATIVE_CUTOFF_PODS)


def _exact_skip_enabled() -> bool:
    """``KARPENTER_DECODE_EXACT_SKIP``: the decoder's multi-group
    exact-skip A/B kill switch, read per call (decode is host-side)."""
    return env_bool("KARPENTER_DECODE_EXACT_SKIP", True)


# the (Bp, level_bits, max_minv) families _invoke has dispatched on the
# device in this process: the JAX package's jit-wrapper cache
# (_PACKED_KERNELS) under the same key, so both packages call a doubled
# family "warm" on the same history and speculate on the same solves
_WARM_FAMILIES: set = set()
# numbers the profiler's trace files apart within one process
_PROFILE_SEQ = itertools.count()


@contextlib.contextmanager
def _profiled(device: torch.device):
    """``KARPENTER_PROFILE_DIR``: profile the enclosed dispatch with
    ``torch.profiler`` (CPU activity, and CUDA activity on a CUDA device)
    and write its Chrome trace into the directory, one file per dispatch
    (the worker name carries host, pid and a per-process number, so two
    dispatches in one millisecond cannot collide). A CUDA dispatch whose
    trace holds no kernel event (no CUPTI) raises. Unset, a no-op."""
    directory = env_str("KARPENTER_PROFILE_DIR")
    if not directory:
        yield
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    worker = f"{socket.gethostname()}_{os.getpid()}_{next(_PROFILE_SEQ)}"
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(
                     directory, worker_name=worker)) as prof:
        yield
    if cuda and not any(ev.device_type() == DeviceType.CUDA
                        for ev in prof.profiler.kineto_results.events()):
        raise RuntimeError(
            f"KARPENTER_PROFILE_DIR: the profiled dispatch's trace ({worker}) "
            "holds no CUDA kernel event; the profiler cannot trace the card")


def _accelerated(device: torch.device) -> bool:
    """Whether ``device`` is an accelerator (CUDA): on the CPU the plain
    PyTorch path only emulates the device kernel and the native engine
    wins at every size. ``KARPENTER_ASSUME_ACCELERATOR`` (1/0) overrides
    the test."""
    v = env_str("KARPENTER_ASSUME_ACCELERATOR")
    if v is not None:
        return v.strip().lower() in ("1", "true", "yes", "on")
    return device.type == "cuda"


class Solver:
    def solve(self, pods, templates, instance_types, **kw) -> SchedulerResults:
        raise NotImplementedError


def _pack_route(args: dict) -> str:
    """How ``kernels.pack`` runs on these tensors: ``kernel`` (one launch
    of ``csrc/pack.cu``, CUDA) or ``plain`` (``pack_reference``, CPU)."""
    return "kernel" if args["g_demand"].is_cuda else "plain"


def packed_solve(args: dict, max_bins: int, level_bits: int, max_minv: int,
                 fma_rem: bool = True) -> torch.Tensor:
    """``solve_step`` on a snapshot's tensors with every output flattened
    into ONE int32 tensor on their device (assign, assign_e, used, tmpl,
    F — the layout ``TorchSolver._unpack`` splits), so the caller reads
    one buffer back. ``fma_rem`` is ``solve_step``'s."""
    out = kernels.solve_step(args, max_bins=max_bins, level_bits=level_bits,
                             max_minv=max_minv, fma_rem=fma_rem)
    return torch.cat([
        out["assign"].ravel(),
        out["assign_e"].ravel(),
        out["used"].to(torch.int32),
        out["tmpl"],
        out["F"].to(torch.int32).ravel(),
    ])


def batched_invoke(args_list, max_bins: int, level_bits: int = 20,
                   max_minv: int = 0, device=None) -> list:
    """Run N same-shape solve snapshots (numpy kernel arguments) as one
    dispatch on ``device`` (CUDA when None; it raises without a card) —
    the solver service's coalesced dispatch, the port of the JAX
    package's ``batched_invoke`` (``jit(vmap(packed))``). The batch is
    stacked and padded to a power of two ``Np`` by repeating the last
    snapshot, uploaded once, and every row's ``solve_step`` is queued on
    one stream with no host read in between; the rows' flat outputs are
    read back as ONE int32 buffer, unpacked per row, and the pad rows
    dropped. Each row runs the batched program's multiply-add rule
    (``fma_rem=False``, ``ops/kernels.py``). Returns one host output dict
    per input, each laid out as ``TorchSolver._invoke``'s. The pow-2
    batch-axis waste and the dispatch land in the device plane under the
    JAX package's ``service.batch`` site and key."""
    device = kernels.resolve_device(device, "the batched solve")
    n = len(args_list)
    Np = 1 << max(n - 1, 0).bit_length() if n > 1 else 1
    base = args_list[0]
    stacked = {
        k: np.stack([np.asarray(a[k]) for a in args_list]
                    + [np.asarray(args_list[-1][k])] * (Np - n))
        for k in base
    }
    devplane.record_padding("service.batch", n, Np)
    t0 = time.perf_counter()
    with obs.span("solve.kernel", kind="device", batch=n):
        dev = kernels.from_kernel_args(stacked, device)
        flat = torch.stack([
            packed_solve({k: v[i] for k, v in dev.items()}, max_bins,
                         level_bits, max_minv, fma_rem=False)
            for i in range(Np)
        ]).cpu().numpy()  # the one device->host read
    devplane.record_dispatch(
        "service.batch",
        (Np, max_bins, level_bits, max_minv,
         tuple(sorted((k, v.shape[1:]) for k, v in stacked.items()))),
        time.perf_counter() - t0)
    return [TorchSolver._unpack(flat[i], args_list[i], max_bins)
            for i in range(n)]


class HostSolver(Solver):
    """The reference algorithm (FFD loop) on the host."""

    def solve(self, pods, templates, instance_types, topology=None,
              existing_nodes=(), daemon_overhead=None, limits=None,
              initial_claims=(), volume_topology=None,
              existing_base=None) -> SchedulerResults:
        # existing_base is a tensor-derivation hint; the host loop has none
        sched = Scheduler(
            templates,
            instance_types,
            topology=topology,
            existing_nodes=existing_nodes,
            daemon_overhead=daemon_overhead,
            remaining_resources=limits,
            volume_topology=volume_topology,
        )
        sched.new_claims = list(initial_claims)
        # the host FFD loop is one opaque leaf in the round's span tree
        with obs.span("solve.host", pods=len(pods)):
            return sched.solve(pods)


def _host_stats(pods, host_routed, reason, **stages) -> dict:
    """``last_device_stats`` of a host-routed solve, whose one
    ``solver.route`` verdict is recorded here."""
    decisions.record_decision("solver.route", "host", reason)
    return dict(groups=0, types=0, device_pods=0, retry_pods=0,
                host_pods=len(pods), existing_pods=0, engine="host",
                host_routed=host_routed, cold_compiles=0,
                pad_waste_ratio=0.0, **stages)


class TorchSolver(Solver):
    def __init__(self, device=None):
        """``device`` defaults to ``cuda`` and then raises when no CUDA
        device is present — the port never drops to the CPU on its own;
        pass ``device="cpu"`` for the plain PyTorch path."""
        if device is None and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSolver runs on CUDA and no CUDA device is present; "
                "pass device='cpu' to run the plain PyTorch path")
        self.device = torch.device("cuda" if device is None else device)
        self.host = HostSolver()
        self.last_device_stats: dict = {}
        # the engine and route of the most recent dispatch are
        # THREAD-LOCAL: the solver service drives one shared solver from
        # concurrent worker threads, and a tenant's replay capture stamped
        # with another tenant's engine would replay on the wrong rung
        self._eng_tls = threading.local()
        self._mesh = None
        self._mesh_checked = False

    def _maybe_mesh(self):
        """The device mesh when the solver's device is CUDA and more than
        one card is attached (``parallel.make_mesh``); None otherwise."""
        if not self._mesh_checked:
            self._mesh_checked = True
            if self.device.type == "cuda" and torch.cuda.device_count() > 1:
                from karpenter_tpu_torch.parallel import make_mesh

                self._mesh = make_mesh()
        return self._mesh

    @property
    def _engine(self) -> str:
        """The engine of this thread's last dispatch: the device type,
        ``native`` or ``remote``."""
        return getattr(self._eng_tls, "engine", self.device.type)

    @_engine.setter
    def _engine(self, value: str):
        self._eng_tls.engine = value

    @property
    def _route(self):
        """(rung, reason) of this thread's last dispatch, recorded as the
        solve's ONE "solver.route" verdict (obs/decisions.py)."""
        return getattr(self._eng_tls, "route", None)

    @_route.setter
    def _route(self, value):
        self._eng_tls.route = value

    def solve(self, pods, templates, instance_types, topology=None,
              existing_nodes=(), daemon_overhead=None, limits=None,
              max_bins: int | None = None, volume_topology=None,
              existing_base=None, tier_of=None) -> SchedulerResults:
        has_topology = bool(getattr(
            topology, "has_groups",
            topology is not None and not isinstance(topology, NullTopology)))
        host_cutoff = 0
        if _native_cutoff() > 0:
            host_cutoff = env_int("KARPENTER_HOST_CUTOFF", HOST_CUTOFF_PODS)
        if not templates or 0 < len(pods) <= host_cutoff:
            reason = "small-batch" if templates else "no-templates"
            self.last_device_stats = _host_stats(
                pods, {reason: len(pods)} if pods else {}, reason)
            return self.host.solve(
                pods, templates, instance_types, topology=topology,
                existing_nodes=existing_nodes, daemon_overhead=daemon_overhead,
                limits=limits, volume_topology=volume_topology)
        existing_nodes = list(existing_nodes)
        stages: dict = {}
        rows0 = (_TZ_STATS["group_row_hits"], _TZ_STATS["group_row_misses"])
        # device-plane deltas for THIS solve: first-sight dispatches and
        # pow-2 padding waste across its dispatches
        dp0 = (devplane.STATS["cold_compiles"],
               devplane.STATS["pad_cells_actual"],
               devplane.STATS["pad_cells_padded"])
        # weight order decides which template a new bin opens from
        # (scheduler.go:267 tries templates in weight order)
        templates = sorted(templates, key=lambda t: (-t.weight, t.nodepool_name))

        if has_topology:
            # topology-constrained batch: the waves compiler turns the
            # self-selecting constraint shapes into zone-pinned subgroups /
            # per-bin caps; everything it can't express routes to the host
            basic, rest = [], []
            with obs.span("solve.classify"):
                for p in pods:
                    ok = p.__dict__.get("_basic_elig_cache")
                    if ok is None:
                        ok = device_basic_eligible(p)
                        p.__dict__["_basic_elig_cache"] = ok
                    (basic if ok else rest).append(p)
            host_routed = {"ineligible-spec": len(rest)} if rest else {}
            t0 = time.perf_counter()
            plan = waves.compile_topology(group_by_signature(basic), topology)
            stages["waves_compile_ms"] = (time.perf_counter() - t0) * 1000.0
            rest.extend(plan.host_pods)
            for reason, n in getattr(plan, "host_reasons", {}).items():
                host_routed[reason] = host_routed.get(reason, 0) + n
            device_groups = plan.device_groups
            if not device_groups:
                self.last_device_stats = _host_stats(
                    pods, host_routed, "no-device-groups", **stages)
                return self.host.solve(
                    pods, templates, instance_types, topology=topology,
                    existing_nodes=existing_nodes,
                    daemon_overhead=daemon_overhead, limits=limits,
                    volume_topology=volume_topology)
            eligible = [p for dg in device_groups for p in dg.pods]
            t0 = time.perf_counter()
            snap = tensorize(None, templates, instance_types,
                             daemon_overhead=daemon_overhead, limits=limits,
                             device_plan=plan)
            stages["tensorize_ms"] = (time.perf_counter() - t0) * 1000.0
            device_plan = plan
        else:
            eligible, rest = [], []
            with obs.span("solve.classify"):
                for p in pods:
                    ok = p.__dict__.get("_elig_cache")
                    if ok is None:
                        ok = device_eligible(p)
                        p.__dict__["_elig_cache"] = ok
                    (eligible if ok else rest).append(p)
            host_routed = {"ineligible-spec": len(rest)} if rest else {}
            if not eligible:
                self.last_device_stats = _host_stats(pods, host_routed,
                                                     "no-eligible")
                return self.host.solve(
                    pods, templates, instance_types,
                    existing_nodes=existing_nodes,
                    daemon_overhead=daemon_overhead, limits=limits,
                    volume_topology=volume_topology)
            t0 = time.perf_counter()
            snap = tensorize(eligible, templates, instance_types,
                             daemon_overhead=daemon_overhead, limits=limits,
                             tier_of=tier_of)
            stages["tensorize_ms"] = (time.perf_counter() - t0) * 1000.0
            device_plan = None
        esnap = None
        if existing_nodes:
            t0 = time.perf_counter()
            if existing_base is not None and device_plan is None:
                # disruption fast path: slice this sub-solve's existing-node
                # tensors out of the round's shared snapshot
                # (ops/consolidate.py DisruptionSnapshot.derive_esnap) —
                # None when a node or group fails to map, and the full
                # build below runs
                esnap = existing_base.derive_esnap(snap, existing_nodes)
            if esnap is None:
                esnap = tensorize_existing(snap, existing_nodes, device_plan)
            stages["tensorize_ms"] += (time.perf_counter() - t0) * 1000.0
        self._route = None
        claims, retry, ecommits = self._run_and_decode(
            snap, esnap, max_bins, stages)
        if self._route is not None:
            # the solve's ONE solver.route verdict: the engine the last
            # dispatch ran on (a doubled re-run overwrites)
            decisions.record_decision("solver.route", *self._route)
        with obs.span("solve.commit"):
            pad_padded = devplane.STATS["pad_cells_padded"] - dp0[2]
            pad_actual = devplane.STATS["pad_cells_actual"] - dp0[1]
            self.last_device_stats = dict(
                cold_compiles=devplane.STATS["cold_compiles"] - dp0[0],
                pad_waste_ratio=(
                    round(1.0 - pad_actual / pad_padded, 4)
                    if pad_padded > 0 else 0.0),
                groups=snap.G,
                types=snap.T,
                existing=esnap.E if esnap is not None else 0,
                device_pods=len(eligible) - len(retry),
                retry_pods=len(retry),
                host_pods=len(rest),
                existing_pods=sum(len(e[1]) for e in ecommits),
                engine=self._engine,
                host_routed=host_routed,
                group_row_cache_hits=_TZ_STATS["group_row_hits"] - rows0[0],
                group_row_cache_misses=_TZ_STATS["group_row_misses"] - rows0[1],
                **stages,
            )
            if esnap is not None:
                _TZ_STATS["existing_solves"] += 1
                _TZ_STATS["existing_placed"] += self.last_device_stats["existing_pods"]
            # commit device placements onto the existing nodes (deferred so a
            # doubled re-run cannot double-apply); the host pass then sees the
            # updated availability/requirements (existingnode.go Add:64)
            for node, node_pods, delta, merged, gcounts in ecommits:
                node.pods.extend(node_pods)
                node.requests = resutil.merge(node.requests, delta)
                node.requirements = merged
                if has_topology:
                    for g, c in gcounts:
                        topology.record_many(snap.groups[g][0], merged, c)
            if has_topology:
                # commit the FINAL claim set into the host topology engine once
                # (a doubled re-run discards its predecessor's claims, so decode
                # itself must not record): register each claim hostname domain
                # (nodeclaim.go:49) and record every landed group with
                # multiplicity (topology.go Record:141), so the host pass and
                # later rounds see the device placements
                for claim in claims:
                    claim.topology = topology
                    topology.register(wk.HOSTNAME_LABEL, claim.hostname)
                    for g, c in getattr(claim, "_gcounts", ()):
                        topology.record_many(snap.groups[g][0], claim.requirements, c)
            # debit nodepool limits for the device-built claims so the host pass
            # can't double-spend them (scheduler.go:292 subtractMax)
            if limits:
                limits = {k: dict(v) for k, v in limits.items()}
                for claim in claims:
                    pool = claim.template.nodepool_name
                    if pool in limits:
                        limits[pool] = subtract_max(limits[pool], claim.instance_types)
        # leftovers + ineligible pods run through the host loop seeded with
        # the device-built claims (they can still land on those bins)
        if rest or retry:
            return self.host.solve(
                rest + retry, templates, instance_types,
                topology=topology if has_topology else None,
                existing_nodes=existing_nodes,
                daemon_overhead=daemon_overhead, limits=limits,
                initial_claims=claims, volume_topology=volume_topology)
        for claim in claims:
            claim.finalize()
        return SchedulerResults(new_claims=claims,
                                existing_nodes=existing_nodes, pod_errors={})

    def plan(self, snap, max_bins=None, esnap=None) -> dict:
        """The dispatch shape of a snapshot: bin axis ``B`` (from the
        per-resource demand lower bound, the topology caps' lower bounds
        and the LP floor, with 1.5x FFD headroom, unless ``max_bins`` pins
        it), its bucket ``Bp``, the padded ``Gp``/``Tp``/``Ep``,
        ``level_bits``, ``max_minv``, the demand ``floor`` and whether the
        LP floor raised it (``lp_led``)."""
        G, T = snap.G, snap.T
        R = len(snap.resources)
        total_pods = int(snap.g_count.sum())
        floor = None  # the demand lower bound
        lp_led = False  # the LP relaxation floor raised it
        if max_bins:
            B = max_bins
        else:
            demand_tot = (snap.g_demand * snap.g_count[:, None]).sum(axis=0)
            max_alloc = snap.t_alloc.max(axis=0) if T else np.ones(R, dtype=np.float32)
            with np.errstate(divide="ignore", invalid="ignore"):
                lb = np.where(max_alloc > 0, np.ceil(demand_tot / max_alloc), 0.0)
            est = int(np.nanmax(lb)) if lb.size else 1
            # bin-cap topology groups force distinct bins: a cap-c group of
            # n pods needs >= ceil(n/c) bins regardless of resource demand
            # (different capped groups may share bins, so max not sum)
            caps = np.maximum(snap.g_bin_cap.astype(np.int64), 1)
            cap_lb = int(np.ceil(snap.g_count / caps).max()) if G else 0
            # self-conflicting anti classes force one pod per bin ACROSS
            # groups (a decl∩match group conflicts with every other group
            # of its class): class c needs >= sum of those groups' counts
            both = snap.g_decl & snap.g_match  # [G,CW]
            if both.any():
                for w in range(both.shape[1]):
                    live = np.bitwise_or.reduce(both[:, w])
                    for bit in range(32):
                        if not (live >> bit) & 1:
                            continue
                        sel = ((both[:, w] >> bit) & 1).astype(bool)
                        cap_lb = max(cap_lb, int(snap.g_count[sel].sum()))
            # spread classes share the per-bin cap ACROSS groups: class c
            # needs >= ceil(sum of owner counts / cap) distinct bins
            owned = snap.g_sown < SPREAD_OWNED_MIN
            if owned.any():
                cnt = snap.g_count[:, None] * owned  # [G,C]
                cap_c = np.where(owned, snap.g_sown, 1).max(axis=0)  # [C]
                cls_lb = np.ceil(cnt.sum(axis=0) / np.maximum(cap_c, 1)).max()
                cap_lb = max(cap_lb, int(cls_lb))
            est = max(est, min(cap_lb, total_pods))
            # LP relaxation floor (ops/relax.py): a weak-duality certified
            # bin lower bound over the same demand/capacity/compat tensors,
            # valid whether or not the iteration converged
            lp = lp_bin_floor(snap, est, self.device)
            if lp > est:
                est, lp_led = lp, True
            floor = est
            # 1.5x FFD headroom: the doubling re-run catches a miss
            B = min(max(total_pods, 1), max((3 * est) // 2, 64), 4096)
        E = esnap.E if esnap is not None else 0
        # the level-fill search range shrinks when every type caps its pod
        # count (kubelet max-pods): levels never exceed npods + take <= 2*cap
        level_bits = 20
        if resutil.PODS in snap.resources:
            pods_idx = snap.resources.index(resutil.PODS)
            pcap = float(snap.t_alloc[:, pods_idx].max())
            # existing nodes may hold AND absorb more pods than this solve's
            # catalog caps: the search range must reach npods + remaining
            # pods capacity or the fill silently under-places on them
            if esnap is not None and esnap.e_npods.size:
                e_need = esnap.e_npods + esnap.e_avail[:, pods_idx]
                pcap = max(pcap, float(e_need.max()))
            if 0 < pcap < 1 << 18:
                level_bits = max(4, int(np.ceil(np.log2(2 * pcap + 4))))
        max_minv = int(snap.m_minv.max()) if snap.m_minv.size else 0
        return dict(B=B, Bp=_bucket(B), Gp=_bucket(G), Tp=_bucket(T),
                    E=E, Ep=_bucket(max(E, 1), lo=8),
                    level_bits=level_bits, max_minv=max_minv,
                    total_pods=total_pods, floor=floor, lp_led=lp_led)

    def _run_and_decode(self, snap, esnap, max_bins, stages):
        """Estimate the bin axis, dispatch, decode; while the estimated
        axis runs dry and pods are left over, re-run with a doubled axis
        (exact, just slower) rather than spill to the host loop. Gates on
        the kernel's own bin usage, not post-validation claim count. The
        doubled axis is dispatched before the decode (``_invoke_spec``:
        queued on the card, or deferred to ``_dispatch``) and read only
        when the decode leaves pods over. Each dispatch, the re-run
        included, goes through the engine gates on the numpy arguments
        (``_dispatch``); the device copy is made at the first dispatch
        that takes the device. Each dispatch records its
        ``solver.invoke`` replay capture."""
        G, T = snap.G, snap.T
        with obs.span("solve.plan"):
            p = self.plan(snap, max_bins, esnap)
        B, Bp, E = p["B"], p["Bp"], p["E"]
        stages["lp_led"] = p["lp_led"]
        stages["floor"] = p["floor"]
        args_np = kernel_args(snap, esnap, Gp=p["Gp"], Tp=p["Tp"], Ep=p["Ep"])
        upload: dict = {}
        compat_cache: dict = {}
        bin_cap = min(p["total_pods"], 4096)
        # the compile ledger's key, as the JAX package builds it: the
        # padded shapes and the static parameters (the tier count rides
        # as a pseudo-static dim)
        base_key = (p["Gp"], p["Tp"], snap.g_mask.shape[1], snap.W,
                    len(snap.resources), len(snap.templates),
                    snap.off_zone.shape[1], snap.g_decl.shape[1],
                    snap.g_sown.shape[1], snap.g_aneed.shape[1],
                    p["Ep"] if esnap is not None else 0, snap.n_tiers)
        statics = (p["level_bits"], p["max_minv"])
        pull = None
        while True:
            t0 = time.perf_counter()
            # pow-2 ladder waste of THIS dispatch (real G×T×B cells vs the
            # padded volume the pack loop walks)
            devplane.record_padding("solve.bins", G * T * B,
                                    p["Gp"] * p["Tp"] * Bp)
            # a speculative pull spends its time here as pure readback:
            # its launch happened before the last decode
            with obs.span("solve.kernel", kind="device", bins=Bp):
                host = pull() if pull is not None else self._dispatch(
                    args_np, base_key + (Bp,) + statics, Bp, upload)
            stages["solve_ms"] = stages.get("solve_ms", 0.0) + (
                time.perf_counter() - t0) * 1000.0
            pull = None
            # replay capsule (obs/capsule.py): this dispatch's exact
            # numpy inputs and host outputs by REFERENCE onto the open
            # round trace (a doubled re-run overwrites — last wins). The
            # mesh route skips here: sharded_solve_host captured the same
            # dispatch at the mesh seam with the shard metadata replay needs
            if self._route is None or self._route[0] != "mesh":
                capsule.record_capture(
                    "solver.invoke", args_np, host,
                    engine=capture_engine(self._engine),
                    rung=self._route[0] if self._route else None,
                    reason=self._route[1] if self._route else None,
                    max_bins=Bp, level_bits=p["level_bits"],
                    max_minv=p["max_minv"], family=f"{p['Gp']}x{p['Tp']}",
                    pallas=False)
            used = host["used"]
            grow = max_bins is None and bool(used[:B].all()) and B < bin_cap
            B2 = min(2 * B, 4096)
            Bp2 = _bucket(B2)
            if grow:
                # the doubled axis goes out NOW, so the card runs it while
                # the host decodes; when the decode leaves no pods over it
                # is thrown away, and the port has paid its host launch of
                # the pack loop on this thread as well as the card's time
                pull = self._invoke_spec(
                    args_np, base_key + (Bp2,) + statics, Bp2, upload)
            assign_e = host["assign_e"][:G, :E] if esnap is not None else None
            t0 = time.perf_counter()
            with obs.span("solve.decode"):
                claims, retry, ecommits = self._decode(
                    snap, esnap, host["assign"][:G], assign_e, used,
                    host["F"][:G, :T], host["tmpl"], compat_cache)
            stages["decode_ms"] = stages.get("decode_ms", 0.0) + (
                time.perf_counter() - t0) * 1000.0
            if retry and grow:
                # the doubled re-run keeps axis exhaustion on the device
                devplane.record_bin_growth()
                stages["bin_growths"] = stages.get("bin_growths", 0) + 1
                B, Bp = B2, Bp2
                continue
            floor = p["floor"]
            if floor is not None and floor > 0 and claims and not retry:
                # solve-quality account: bins opened vs the demand lower
                # bound; a steady-state drift fires solve-overhead-drift
                # (obs/decisions.py; family = the compiled shape bucket)
                decisions.record_quality(len(claims), floor,
                                         family=f"{p['Gp']}x{p['Tp']}")
            if p["lp_led"] and claims and not retry:
                # the LP floor sized a solve that completed whole: the
                # relax rung, as the JAX package's route records it
                self._route = ("relax", "ok")
            stages.update(bins=Bp, B=B, Gp=p["Gp"], Ep=p["Ep"])
            return claims, retry, ecommits

    def _dispatch(self, args_np, key, max_bins, upload=None):
        """One dispatch of a snapshot's numpy kernel arguments, routed by
        the engine gates (``_native_reason``): the native engine, the mesh
        (``_maybe_mesh``, above ``SHARD_MIN_WORK``, on the numpy arguments),
        or the device — uploaded with ``from_kernel_args`` (once per ``upload``
        dict, which a solve's doubled re-runs share) and run by
        ``_invoke``. ``key`` is the compile ledger's; its last two
        entries are ``level_bits`` and ``max_minv``. Returns the host
        output dict and leaves this thread's ``_engine``/``_route`` set.
        Under ``KARPENTER_PROFILE_DIR`` the mesh or device part is
        profiled (``_profiled``). The solver service's server calls this
        on the arguments a client shipped."""
        reason = self._native_reason(args_np)
        if reason is not None:
            host = self._invoke_native(args_np, max_bins, reason)
            if host is not None:
                return host
        mesh = self._maybe_mesh()
        G, K, W = args_np["g_mask"].shape
        T = args_np["t_mask"].shape[0]
        with _profiled(self.device):
            if mesh is not None and G * T * K * W >= SHARD_MIN_WORK:
                from karpenter_tpu_torch.parallel import sharded_solve_host

                # the shard-stage decomposition (shard.pad/tensorize/
                # dispatch/block/merge leaves + the mesh.shard
                # compile-ledger family) lives inside the parallel module
                self._engine = "mesh"
                self._route = ("mesh", "ok")
                return sharded_solve_host(mesh, args_np, max_bins,
                                          level_bits=key[-2])
            if upload is None:
                upload = {}
            if "args" not in upload:
                upload["args"] = kernels.from_kernel_args(args_np,
                                                          self.device)
            self._engine = self.device.type
            self._route = ("device", "ok")
            return self._invoke(upload["args"], max_bins, key[-2], key[-1],
                                key=key)

    def _native_reason(self, args_np) -> str | None:
        """The gate of one dispatch, decided on the numpy arguments: the
        reason it goes to the native engine (``small-batch``,
        ``work-floor``, ``cpu-backend``), or None for the device. Counts
        REAL groups and types (padded groups count 0 pods and padded types
        have no allocatable), so routing flips at the calibrated work,
        not at shape-bucket boundaries."""
        cutoff = _native_cutoff()
        g_count = np.asarray(args_np["g_count"])
        total = int(g_count.sum())
        if cutoff <= 0 or total <= 0:
            return None
        min_work = env_int("KARPENTER_DEVICE_MIN_WORK", DEVICE_MIN_WORK)
        work = int((g_count > 0).sum()) * int(
            (np.asarray(args_np["t_alloc"]).max(axis=1) > 0).sum())
        if total <= cutoff:
            reason = "small-batch"
        elif work < min_work:
            reason = "work-floor"
        elif not _accelerated(self.device):
            reason = "cpu-backend"
        else:
            return None
        return reason if native.available() else None

    def _invoke_native(self, args_np, max_bins, reason):
        """One dispatch on the native engine; None when the engine fails,
        which is logged, and the dispatch then takes the device."""
        try:
            with obs.span("solve.native", kind="device"):
                out = native.solve_step(args_np, max_bins)
        except (RuntimeError, ValueError):
            logging.getLogger(__name__).warning(
                "native engine failed on a routed batch; falling back to "
                "the device kernel", exc_info=True)
            return None
        self._engine = "native"
        self._route = ("native", reason)
        return out

    def _invoke(self, args, max_bins, level_bits, max_minv, key):
        """One device dispatch: solve_step with every output flattened into
        ONE int32 buffer, read back to the host once. ``solve.dispatch``
        holds the eager launch of the pack loop (PyTorch queues the
        kernels and returns), ``solve.block`` the readback, where the
        host waits for the card; ``key`` is the compile ledger's."""
        _WARM_FAMILIES.add((max_bins, level_bits, max_minv))
        t0 = time.perf_counter()
        with obs.span("solve.dispatch", kind="device",
                      Gp=args["g_mask"].shape[0], Bp=max_bins,
                      level_bits=level_bits, pack=_pack_route(args)):
            flat = packed_solve(args, max_bins, level_bits, max_minv)
        # a first-sight key's seconds are its launch: CUDA's first use and
        # the compat build, where the JAX package pays its XLA compile
        devplane.record_dispatch("solve.kernel", key,
                                 time.perf_counter() - t0)
        with obs.span("solve.block", kind="device"):
            host = flat.cpu().numpy()  # one device->host read
        return self._unpack(host, args, max_bins)

    def _invoke_spec(self, args_np, key, max_bins, upload):
        """The doubled bin axis, dispatched before the decode that decides
        whether it is needed; returns the pull that yields its host dict.
        When the doubled family is warm (``_WARM_FAMILIES``), the last
        dispatch took the device rung, there is no mesh and no profile is
        being taken, ``packed_solve`` is queued now on the tensors already
        uploaded, inside ``solve.dispatch_spec``, and the pull reads the
        flat buffer back once. The launch runs on the calling thread: on
        the card the host's launch of the pack loop moves ahead of the
        decode and is not hidden; the card's run of it overlaps the
        decode. Otherwise, and when the launch raises a
        device fault, the pull is the ordinary ``_dispatch`` (the engine
        gates again, on the same device; a repeated fault raises there)."""
        def deferred():
            return self._dispatch(args_np, key, max_bins, upload)

        if not ((max_bins, key[-2], key[-1]) in _WARM_FAMILIES
                and self._route == ("device", "ok")
                and self._maybe_mesh() is None
                and not env_str("KARPENTER_PROFILE_DIR")):
            return deferred
        args = upload["args"]
        try:
            t0 = time.perf_counter()
            with obs.span("solve.dispatch_spec", kind="device",
                          Gp=args["g_mask"].shape[0], Bp=max_bins,
                          level_bits=key[-2], pack=_pack_route(args)):
                flat = packed_solve(args, max_bins, key[-2], key[-1])
            devplane.record_dispatch("solve.kernel", key,
                                     time.perf_counter() - t0)
        except DEVICE_FAULTS:
            logging.getLogger(__name__).warning(
                "speculative doubled dispatch failed; deferring to the "
                "ordinary dispatch", exc_info=True)
            return deferred
        return lambda: self._unpack(flat.cpu().numpy(), args, max_bins)

    @staticmethod
    def _unpack(flat, args, max_bins):
        """Split the single flattened int32 buffer back into the
        assign/assign_e/used/tmpl/F host dict."""
        G = args["g_mask"].shape[0]
        T = args["t_mask"].shape[0]
        B = max_bins
        E = args["e_avail"].shape[0] if "e_avail" in args else 1
        sizes = [G * B, G * E, B, B, G * T]
        offs = np.cumsum([0] + sizes)
        return {
            "assign": flat[offs[0] : offs[1]].reshape(G, B),
            "assign_e": flat[offs[1] : offs[2]].reshape(G, E),
            "used": flat[offs[2] : offs[3]].astype(bool),
            "tmpl": flat[offs[3] : offs[4]],
            "F": flat[offs[4] : offs[5]].reshape(G, T).astype(bool),
        }

    def _compat_entry(self, snap, feas, m, gset, template):
        """Distinct-(template, group-set) candidate types + precomputed fit
        thresholds. Candidate types: AND of the device's per-group
        feasibility rows — a sound PREFILTER, not the joint answer (F is
        pairwise, so it misses three-way value intersections and
        cross-offering splits). The host re-checks the MERGED requirement
        set on every survivor unless the set provably decomposes.

        Entries persist across solves in the type-side cache, keyed by
        (template index, per-group signature keys, the exact-skip knob)."""
        persist = getattr(snap, "compat_cache", None)
        row_keys = getattr(snap, "row_keys", None)
        pkey = None
        if persist is not None and row_keys is not None:
            # the exact-skip knob steers the entry's exactness arm below
            # and the type-side key does not pin it: it rides the key, or
            # a knob flip would serve stale entries
            pkey = (m, tuple(row_keys[g] for g in gset),
                    _exact_skip_enabled())
            hit = persist.get(pkey)
            if hit is not None:
                return hit
        bin_reqs = template.requirements.copy()
        for g in gset:
            bin_reqs.add(*snap.group_reqs[g].values())
        joint = feas[gset[0]]
        for g in gset[1:]:
            joint = joint & feas[g]
        tsel = np.flatnonzero(joint & (snap.t_tmpl == m))
        # bins whose merged requirement set provably DECOMPOSES need no
        # merged re-check (see _decomposable)
        tmeta = getattr(snap, "_tmpl_keymeta", None)
        if tmeta is None:
            tmeta = [
                (
                    frozenset(tpl.requirements.keys()),
                    wk.TOPOLOGY_ZONE_LABEL not in tpl.requirements
                    and wk.CAPACITY_TYPE_LABEL not in tpl.requirements,
                )
                for tpl in snap.templates
            ]
            snap._tmpl_keymeta = tmeta
        tkeys, off_free = tmeta[m]
        # the decision tree splits so the decode.recheck verdict can carry
        # WHY the exactness argument did not apply (obs/decisions.py)
        if not off_free:
            exact, why = False, "offering-keys"
        elif not all(tkeys.isdisjoint(snap.group_reqs[g].keys())
                     for g in gset):
            exact, why = False, "group-key-overlap"
        elif len(gset) == 1 or self._decomposable(snap, gset):
            exact, why = True, "ok"
        elif not _exact_skip_enabled():
            exact, why = False, "disabled"
        else:
            exact, why = False, "non-decomposable"
        decisions.record_decision(
            "decode.recheck", "skip" if exact else "full",
            "no-candidates" if exact and not tsel.size else why)
        if exact and tsel.size:
            _TZ_STATS["decode_exact_skips"] += 1
        if tsel.size and not exact:
            mask_bin, has_bin, tol_bin = snap.mask_set(bin_reqs)
            tm, th, tt = snap.t_mask[tsel], snap.t_has[tsel], snap.t_tol[tsel]
            shared = th & has_bin[None, :]
            overlap = ((tm & mask_bin[None, :, :]) != 0).any(axis=2)
            # Intersects tolerates an empty meet iff BOTH operators are
            # NotIn/DoesNotExist (requirements.py:249)
            both_tol = tt & tol_bin[None, :]
            req_ok = (~shared | overlap | both_tol).all(axis=1)
            # offerings: available ∧ zone/capacity-type bit of the offering
            # inside the bin's merged allowed sets
            off_ok = snap.off_avail[tsel].copy()
            for label, off_idx in (
                (wk.TOPOLOGY_ZONE_LABEL, snap.off_zone[tsel]),
                (wk.CAPACITY_TYPE_LABEL, snap.off_ct[tsel]),
            ):
                k = snap.key_index.get(label)
                if k is None or not has_bin[k]:
                    continue
                nv = len(snap.vocab[label])
                if nv == 0:
                    continue
                bits = np.arange(nv)
                allowed = ((mask_bin[k, bits // 32] >> (bits % 32)) & 1).astype(bool)
                off_ok &= np.where(off_idx >= 0, allowed[np.maximum(off_idx, 0)], True)
            tsel = tsel[req_ok & off_ok.any(axis=1)]
        tobj = getattr(snap, "_type_obj_arr", None)
        if tobj is None:
            tobj = np.array([it for _, it in snap.type_refs], dtype=object)
            snap._type_obj_arr = tobj
        objs = list(tobj[tsel]) if tsel.size else []
        # allocatable/capacity rows with the fit tolerance pre-applied
        alloc = snap.alloc64()[tsel]
        alloc_thresh = alloc + resutil._EPS + resutil.FIT_REL_EPS * np.abs(alloc)
        tcap = snap.cap64()[tsel]
        entry = (bin_reqs, objs, alloc_thresh, tcap, tsel)
        if pkey is not None:
            if len(persist) >= _COMPAT_CACHE_MAX:
                persist.pop(next(iter(persist)))
            persist[pkey] = entry
        return entry

    @staticmethod
    def _decomposable(snap, gset) -> bool:
        """Multi-group arm of the decoder's exact-skip: True when the bin's
        merged requirement set decomposes per key into single-group checks
        F already made (keys carried by 2+ groups have bit-equal rows, and
        offering-constraining groups agree on zone and capacity type), so
        the merged re-check cannot remove a candidate. False when
        ``KARPENTER_DECODE_EXACT_SKIP`` is 0."""
        if not _exact_skip_enabled():
            return False
        has, mask, tol = snap.g_has, snap.g_mask, snap.g_tol
        carriers: list = [None] * has.shape[1]
        for g in gset:
            for k in np.flatnonzero(has[g]):
                first = carriers[k]
                if first is None:
                    carriers[k] = g
                elif (tol[g, k] != tol[first, k]
                      or (mask[g, k] != mask[first, k]).any()):
                    return False
        zk = snap.key_index.get(wk.TOPOLOGY_ZONE_LABEL)
        ck = snap.key_index.get(wk.CAPACITY_TYPE_LABEL)
        off_keys = [k for k in (zk, ck) if k is not None]
        if off_keys:
            offg = [g for g in gset if any(has[g, k] for k in off_keys)]
            g0 = offg[0] if offg else None
            for g in offg[1:]:
                for k in off_keys:
                    if has[g, k] != has[g0, k]:
                        return False
                    if has[g0, k] and (
                        tol[g, k] != tol[g0, k]
                        or (mask[g, k] != mask[g0, k]).any()
                    ):
                        return False
        return True

    def _decode(self, snap, esnap, assign, assign_e, used, feas, tmpl,
                compat_cache):
        """Bins → InFlightNodeClaims, with host-side validation of each
        claim's joint instance-type set (the kernel approximates joint
        offering feasibility by intersecting per-group feasibility).
        Existing-node columns decode first (phase-A pods are the head of
        each group) into deferred commit entries — validation is exact
        host-side (requirement compat + float64 fit) and a failed node
        routes its pods to retry without mutating the ExistingNode.
        ``compat_cache`` carries distinct-(template, group-set) entries
        across the doubled re-runs of one solve."""
        from karpenter_tpu_torch.cloudprovider.types import satisfies_min_values

        cursors = [0] * snap.G
        claims = []
        retry = []
        ecommits = []
        R = len(snap.resources)
        # per-pod demand in float64 from the source dicts — the f32 kernel
        # tensors are too coarse at memory-byte scale; shared by the
        # existing-node and claim decodes
        demand64 = np.array(
            [[d.get(r, 0.0) for r in snap.resources] for d in snap.group_demand],
            dtype=np.float64,
        ).reshape(snap.G, R)
        if esnap is not None and assign_e is not None:
            for e in np.flatnonzero(assign_e.sum(axis=0) > 0):
                node = esnap.nodes[int(e)]
                counts = assign_e[:, e]
                gidx = np.flatnonzero(counts)
                merged = node.requirements.copy()
                node_pods = []
                gcounts = []
                ok = True
                for g in gidx:
                    reqs = snap.group_reqs[int(g)]
                    if merged.compatible(reqs) is not None:
                        ok = False
                        break
                    merged.add(*reqs.values())
                req_vec = counts[gidx].astype(np.float64) @ demand64[gidx]
                delta = {
                    r: float(v)
                    for r, v in zip(snap.resources, req_vec.tolist())
                    if v > 0
                }
                if ok:
                    total = resutil.merge(node.requests, delta)
                    ok = resutil.fits(total, node.cached_available)
                for g in gidx:
                    c = int(counts[g])
                    taken = snap.groups[int(g)][cursors[int(g)] : cursors[int(g)] + c]
                    cursors[int(g)] += c
                    if ok:
                        node_pods.extend(taken)
                        gcounts.append((int(g), c))
                    else:
                        retry.extend(taken)
                if ok:
                    ecommits.append((node, node_pods, delta, merged, gcounts))
        topology = NullTopology()
        # nodepool-limit accounting mirroring the kernel's: a bin's
        # candidate types are filtered to those whose worst-case capacity
        # fits the remaining limits at open time, and the surviving worst
        # case is debited
        rem_limits = snap.m_limits.astype(np.float64).copy()
        Bax = assign.shape[1]
        cols = np.flatnonzero(used[:Bax] & (assign.sum(axis=0) > 0))
        breq = assign[:, cols].T.astype(np.float64) @ demand64
        breq += snap.m_overhead.astype(np.float64)[tmpl[cols]]
        sub = assign[:, cols]
        nz_ci, nz_gi = np.nonzero(sub.T)  # (bin-column, group) pairs, ci-major
        counts_flat = sub.T[nz_ci, nz_gi]
        row_starts = np.searchsorted(nz_ci, np.arange(len(cols)))
        row_ends = np.append(row_starts[1:], len(nz_ci))
        tmpl_cols = tmpl[cols]
        overhead_dicts = [
            dict(zip(snap.resources, row.tolist())) for row in snap.m_overhead
        ]
        # pass 1: per-bin memberships + cache keys (the exact-skip knob
        # rides them: compat_cache outlives this decode, across the
        # solve's doubled re-runs)
        skip = _exact_skip_enabled()
        bin_keys = []
        bin_meta = []  # (m, bin_pods, gcounts)
        key_rows: dict = {}  # key -> [ci...]
        for ci in range(len(cols)):
            m = int(tmpl_cols[ci])
            bin_pods = []
            gset = []
            gcounts = []
            for j in range(row_starts[ci], row_ends[ci]):
                g = int(nz_gi[j])
                c = int(counts_flat[j])
                gset.append(g)
                gcounts.append((g, c))
                bin_pods.extend(snap.groups[g][cursors[g] : cursors[g] + c])
                cursors[g] += c
            key = (m, tuple(gset), skip)
            bin_keys.append(key)
            bin_meta.append((m, bin_pods, gcounts))
            key_rows.setdefault(key, []).append(ci)

        # pass 2: distinct-key candidate sets + batched resource fit;
        # nodepool limits keep the sequential per-bin path
        no_limits = not np.isfinite(snap.m_limits).any()
        fit_rows = [None] * len(cols)
        its_rows = [None] * len(cols)
        for key, rows in key_rows.items():
            m, gset = key[0], list(key[1])
            cached = compat_cache.get(key)
            if cached is None:
                cached = self._compat_entry(snap, feas, m, gset, snap.templates[m])
                compat_cache[key] = cached
            _, objs, alloc_thresh, _, _ = cached
            rb = breq[rows]
            if no_limits:
                if len(rows) == 1:
                    row = (rb[0] <= alloc_thresh).all(axis=1)
                    fit_rows[rows[0]] = row
                    its_rows[rows[0]] = (
                        objs if row.all() else [objs[i] for i in np.flatnonzero(row)]
                    )
                    continue
                # clone bins (same key, same totals) share their candidates
                ub, inv = np.unique(rb, axis=0, return_inverse=True)
                ufits = (ub[:, None, :] <= alloc_thresh[None, :, :]).all(axis=2)
                uits = [
                    objs if row.all() else [objs[i] for i in np.flatnonzero(row)]
                    for row in ufits
                ]
                for i, ci in enumerate(rows):
                    fit_rows[ci] = ufits[inv[i]]
                    its_rows[ci] = uits[inv[i]]
            else:
                fits = (rb[:, None, :] <= alloc_thresh[None, :, :]).all(axis=2)
                for i, ci in enumerate(rows):
                    fit_rows[ci] = fits[i]

        for ci in range(len(cols)):
            m, bin_pods, gcounts = bin_meta[ci]
            template = snap.templates[m]
            requests = {
                r: float(v) for r, v in zip(snap.resources, breq[ci].tolist()) if v > 0
            }
            bin_reqs, objs, _alloc_thresh, tcap, _ = compat_cache[bin_keys[ci]]
            ok = fit_rows[ci]
            if no_limits:
                its = its_rows[ci]  # InFlightNodeClaim copies its input list
            else:
                ok = ok & (
                    tcap <= rem_limits[m] + resutil._EPS
                    + resutil.FIT_REL_EPS * np.abs(rem_limits[m])
                ).all(axis=1)
                its = [objs[i] for i in np.flatnonzero(ok)]
            claim = InFlightNodeClaim(
                template,
                topology,
                overhead_dicts[m],
                its,
                requirements=bin_reqs.copy(),
            )
            claim.pods = bin_pods
            claim.requests = requests
            remaining = claim.instance_types
            if remaining and claim.requirements.has_min_values():
                _, err = satisfies_min_values(remaining, claim.requirements)
                if err:
                    remaining = []
            if not remaining:
                retry.extend(bin_pods)
                continue
            claim.instance_types = remaining
            # debit only once the claim survives validation
            if not no_limits:
                rem_limits[m] -= tcap[ok].max(axis=0)
            claim._gcounts = gcounts  # for the solver's topology commit
            if snap.g_tier is not None and gcounts:
                # tier of the bin's OPENING group (the first group index
                # with pods here — group order IS scan order, and a bin is
                # first used at its opening step), so the fused admission
                # round can charge each claim to the tier that opened it
                claim._tier = int(snap.g_tier[gcounts[0][0]])
            claims.append(claim)
        # pods the kernel couldn't place (unsched counts are implied by the
        # unconsumed remainder of each group)
        for g in range(snap.G):
            retry.extend(snap.groups[g][cursors[g] :])
        return claims, retry, ecommits


class NativeSolver(TorchSolver):
    """The same tensorize → kernel → decode pipeline with the native C++
    engine in place of the device kernel for every solve dispatch. Its
    ``device`` runs the rest — the LP floor, the disruption bundle and
    probes above the work floor — and follows ``TorchSolver``'s rule:
    None means CUDA and raises without it; pass ``device="cpu"``."""

    def _native_reason(self, args_np) -> str:
        return "ok"

    def _invoke_native(self, args_np, max_bins, reason):
        self._engine = "native"
        self._route = ("native", reason)
        return native.solve_step(args_np, max_bins)


def make_solver(prefer_device: bool = True) -> Solver:
    """The default solver: ``TorchSolver()`` on the card (it raises without
    one — the port never drops to the host on its own); with
    ``prefer_device=False`` the native engine on the CPU, or the host FFD
    loop when there is no g++."""
    if prefer_device:
        return TorchSolver()
    if native.available():
        return NativeSolver(device="cpu")
    return HostSolver()
