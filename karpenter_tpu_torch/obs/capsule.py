"""Anomaly replay capsules: capture any hot-path dispatch, replay it offline.

The port's copy of ``karpenter_tpu/obs/capsule.py``: the capture, the
file format, the index, ``parity_of``, ``replay`` and ``ab_compare`` are
the JAX package's with the imports changed; the replay runners run the
port's engines. One file format serves both packages: a capsule either
package writes, the other loads and replays (same ``SCHEMA_VERSION``,
same ``in//``/``out//``/``cf//`` key layout, same JSON header).

The flight recorder (obs/recorder.py) shows *where* a bad round spent its
time, the devplane *what it launched*, and the decision ledger *which
rung it fell to* — none of them can reproduce the round. Every hot-path
dispatch seam records a **capture** — the solver's exact tensorized
inputs (host numpy, never read back from the card for the capture), its
outputs (the host copies the path already holds), the engine/rung route,
and the static parameters needed to re-execute the dispatch — by
REFERENCE onto the open round's trace (``Trace.add_capture``).
Anomaly-free rounds pay only that reference. When a round closes
**anomalous** (any recorder trigger) — or always, under
``KARPENTER_CAPSULE=1`` — the pending capture serializes to ONE
schema-versioned ``.capsule.npz`` file next to the round's Chrome dump,
carrying the env-knob snapshot (:func:`karpenter_tpu_torch.utils.envknobs.
snapshot`), the shape-family key, and the round's decision-ledger
verdicts.

Capture seams (each one host-side hook per dispatch):

- ``solver.invoke`` — models/solver.py ``TorchSolver._run_and_decode``
  (device / native / remote engines).
- ``probe.dispatch`` — ops/consolidate.py ``DisruptionSnapshot.dispatch``
  (the counterfactual rows, their zeroed-column sets, and the master
  existing-node tensor).
- ``global.dispatch`` — the same dispatch run by ``joint_retirement_plan``
  as one joint ladder over every candidate.
- ``interruption.dispatch`` — the same dispatch run by
  ``InterruptionDrain``'s absorb probe (controllers/disruption/methods.py).
- ``preempt.dispatch`` — admission/preempt.py's probes (per-row capacity
  releases ride as sidecars).
- ``service.solve`` — service/solver_service.py (tenant-scoped).
- ``relax.dispatch`` — ops/relax.py ``joint_relax_plan``: the padded LP
  tensors plus the standard counterfactual-row sidecars on one capture.
- ``mesh.solve`` — parallel/mesh.py ``sharded_solve_host`` (partitioned /
  replicated / unsharded rungs, with the shard count).

Replay (``python -m karpenter_tpu_torch.obs replay <capsule>``)
re-executes the capture and grades it against the captured outputs:
partitioned mesh captures re-run ``partitioned_reference`` (the sequential
one-device oracle that is bit-identical to the mesh execution) with the
captured shard count and partition knobs, replicated ones the replicated
program over a real multi-card mesh or else the plain ``solve_step``
(bit-identical by that rung's contract), device captures re-run
``kernels.solve_step`` on the replay device
(``--device cpu`` for the plain path; CUDA by default), native captures
the C++ engine, the row seams the port's ``dispatch_counterfactual_rows``
(shared code, not a re-implementation), and relax captures the port's LP
and rounding window. ``replay --ab`` runs the same capsule across every
eligible rung and reports a parity + nodes + wall-clock + decision table
(grades: ``exact`` bit-equal, ``placed`` same per-group placement totals
and node count on a different bin axis, ``differs``).

Rung names: the port's engine rung is ``device`` where the JAX package
says ``xla``. A capture's engine is written as the JAX package writes it
(``device``, ``native``, ``remote``, ``relax``), so the JAX package
replays the port's capsules on its ``xla`` rung; reading, ``xla`` (a
``--rung`` or a captured ``rung`` static) means ``device`` here.

The relax seam's graded output is the decision ``k_sel``: the LP's
fractional ``y`` is a float32 iteration whose reductions round
differently on the card, on the CPU and under XLA, so the port records it
as the ``cf//rx_y`` sidecar and its relax rung returns ``k_sel`` alone
(the JAX package grades a port capsule on ``k_sel`` the same way, since
``parity_of`` compares the keys both sides hold). A JAX-written relax
capsule carries ``out//y``, which the port's replay leaves ungraded for
the same reason.

Size budget: a capture whose arrays exceed ``KARPENTER_CAPSULE_BYTES``
(default 256 MiB) is skipped, counted on
``karpenter_capsule_skipped_total{reason="bytes"}``, and logged. Written
capsules count on ``karpenter_capsule_writes_total{seam,why}`` and join
the in-process index served by ``/introspect``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

import numpy as np

from karpenter_tpu_torch.utils import envknobs

__all__ = [
    "SCHEMA_VERSION",
    "SEAMS",
    "Capsule",
    "ReplayError",
    "record_capture",
    "write_capsule",
    "maybe_write_round",
    "last_capture",
    "load",
    "replay",
    "ab_compare",
    "parity_of",
    "index",
    "capture_enabled",
    "force_all",
    "byte_budget",
    "STATS",
    "reset",
]

SCHEMA_VERSION = 1
META_KEY = "__capsule__"
IN_PREFIX = "in//"
OUT_PREFIX = "out//"
# replay-only sidecar arrays (probe counterfactual rows etc.) that are not
# kernel args; the prefix keeps them from colliding with snapshot names
CF_PREFIX = "cf//"

SEAMS = ("solver.invoke", "mesh.solve", "probe.dispatch", "service.solve",
         "preempt.dispatch", "global.dispatch", "interruption.dispatch",
         "relax.dispatch")

_LOCK = threading.Lock()
_TLS = threading.local()
_INDEX: deque = deque(maxlen=64)
STATS = {"captures": 0, "writes": 0, "skipped_bytes": 0}

# knobs from the captured env snapshot that replay re-applies around the
# mesh rungs: they decide whether/how the snapshot partitions, so a dev
# box with different settings must still reproduce the captured plan
_REPLAY_ENV = ("KARPENTER_SHARD_PARTITION", "KARPENTER_SHARD_REPAIR_MAX")


class ReplayError(RuntimeError):
    """A capsule cannot be replayed here (engine unavailable, rung not in
    the port, schema unknown)."""


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------


def capture_enabled() -> bool:
    """KARPENTER_CAPSULE=0 disables capture entirely; anything else (incl.
    unset) keeps the cheap reference-capture on — writes still gate on an
    anomaly unless :func:`force_all`."""
    return envknobs.env_bool("KARPENTER_CAPSULE", True)


def force_all() -> bool:
    """KARPENTER_CAPSULE=1: write a capsule for every recorded round, not
    only anomalous ones (the opt-in knob)."""
    return (envknobs.env_str("KARPENTER_CAPSULE", "") or "").strip().lower() in (
        "1", "true", "on", "yes", "all",
    )


def byte_budget() -> int:
    """KARPENTER_CAPSULE_BYTES: array-byte cap per capsule (0 = uncapped)."""
    return envknobs.env_int("KARPENTER_CAPSULE_BYTES", 256 << 20, minimum=0)


# ---------------------------------------------------------------------------
# capture (the host-side hook)
# ---------------------------------------------------------------------------


def record_capture(seam: str, inputs: dict, outputs: dict,
                   tenant: str | None = None, **meta):
    """One dispatch's replay record, attached by reference to the open
    round trace (and kept as this thread's ``last_capture``). ``inputs``
    and ``outputs`` are host numpy dicts at every call site; only the
    DICTS are copied here — the arrays are shared, so the hook costs one
    small dict build per dispatch."""
    if seam not in SEAMS:
        raise ValueError(f"unknown capture seam {seam!r}")
    if not capture_enabled():
        return None
    rec = {
        "seam": seam,
        "tenant": tenant,
        "meta": dict(meta),
        "inputs": dict(inputs),
        "outputs": dict(outputs),
        "at": time.time(),
    }
    with _LOCK:
        STATS["captures"] += 1
    _TLS.last = rec
    from karpenter_tpu_torch.obs import trace as _trace

    tr = _trace.TRACER.current_trace()
    if tr is not None:
        tr.add_capture(rec)
    return rec


def last_capture():
    """This thread's most recent capture record."""
    return getattr(_TLS, "last", None)


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------


def _array_bytes(rec: dict) -> int:
    return int(sum(np.asarray(v).nbytes
                   for d in (rec["inputs"], rec["outputs"])
                   for v in d.values()))


def write_capsule(rec: dict, directory: str | None = None, trace=None,
                  path: str | None = None, why: str = "anomaly",
                  registry=None) -> str | None:
    """Serialize one capture record to a ``.capsule.npz`` file. Returns
    the path, or None when the size budget refused it or the write failed
    (a capsule failure must never fail the round that triggered it)."""
    nbytes = _array_bytes(rec)
    budget = byte_budget()
    if budget and nbytes > budget:
        with _LOCK:
            STATS["skipped_bytes"] += 1
        _count(registry, trace, skipped=True, seam=rec["seam"],
               reason="bytes")
        import logging

        logging.getLogger(__name__).warning(
            "replay capsule skipped: %d array bytes exceed "
            "KARPENTER_CAPSULE_BYTES=%d (seam %s)", nbytes, budget,
            rec["seam"])
        return None
    meta = {
        "schema": SCHEMA_VERSION,
        "seam": rec["seam"],
        "tenant": rec["tenant"],
        "meta": _jsonable_dict(rec["meta"]),
        "env": envknobs.snapshot(),
        "at": rec["at"],
        "nbytes": nbytes,
        "why": why,
    }
    if trace is not None:
        meta.update(
            round=trace.name,
            trace_id=trace.trace_id,
            anomalies=[k for k, _, _ in trace.anomalies],
            decisions=[
                {"site": s, "rung": r, "reason": why_, "n": n}
                for (s, r, why_), n in sorted(
                    getattr(trace, "decisions", {}).items())
            ],
            dump=trace.dump_path,
        )
    try:
        if path is None:
            directory = directory or "."
            os.makedirs(directory, exist_ok=True)
            tenant_tag = f"-{rec['tenant']}" if rec.get("tenant") else ""
            stem = (f"{meta.get('round', 'capsule')}{tenant_tag}-"
                    f"{meta.get('trace_id') or format(os.getpid(), 'x')}")
            path = os.path.join(directory, f"{stem}.capsule.npz")
        payload: dict = {}
        for k, v in rec["inputs"].items():
            payload[IN_PREFIX + k] = np.asarray(v)
        for k, v in rec["outputs"].items():
            payload[OUT_PREFIX + k] = np.asarray(v)
        payload[META_KEY] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
        with open(path, "wb") as f:
            np.savez(f, **payload)
    except OSError:
        import logging

        logging.getLogger(__name__).warning(
            "replay capsule write failed (seam %s)", rec["seam"],
            exc_info=True)
        return None
    entry = {
        "path": path,
        "seam": rec["seam"],
        "tenant": rec.get("tenant"),
        "round": meta.get("round"),
        "trace_id": meta.get("trace_id"),
        "engine": rec["meta"].get("engine"),
        "anomalies": meta.get("anomalies") or [],
        "nbytes": nbytes,
        "at": rec["at"],
        "why": why,
    }
    with _LOCK:
        STATS["writes"] += 1
        _INDEX.append(entry)
    _count(registry, trace, skipped=False, seam=rec["seam"], reason=why)
    return path


def _jsonable_dict(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = [x if isinstance(x, (str, int, float, bool)) else str(x)
                      for x in v]
        else:
            out[k] = str(v)
    return out


def _count(registry, trace, skipped: bool, seam: str, reason: str):
    reg = registry
    if reg is None and trace is not None:
        reg = trace.registry
    if reg is None:
        return
    from karpenter_tpu_torch.operator import metrics as m

    if skipped:
        reg.counter(
            m.CAPSULE_SKIPPED,
            "replay captures refused by the KARPENTER_CAPSULE_BYTES budget",
        ).inc(seam=seam, reason=reason)
    else:
        reg.counter(
            m.CAPSULE_WRITES, "replay capsule files written",
        ).inc(seam=seam, why=reason)


def maybe_write_round(trace, directory: str | None) -> str | None:
    """The flight recorder's hook: serialize the round's pending capture
    when the round is anomalous (or KARPENTER_CAPSULE=1 forces it).
    Idempotent per trace — a re-recorded round reuses its path. A round
    that writes NOTHING drops its pending reference here: the recorder
    ring retains up to 32 rounds, and pinning every clean round's tensors
    for observability would be a slow leak. The thread's
    ``last_capture`` slot still holds the most recent one."""
    rec = getattr(trace, "capsule_pending", None)
    if rec is None:
        return None
    if trace.capsule_path is not None:
        return trace.capsule_path
    if trace.anomalies:
        why = "anomaly"
    elif force_all():
        why = "forced"
    else:
        trace.capsule_pending = None
        return None
    path = write_capsule(rec, directory, trace=trace, why=why)
    if path is not None:
        trace.capsule_path = path
        trace.capsule_pending = None  # on disk now; don't pin the arrays
    return path


def index(k: int | None = None) -> list:
    """The in-process capsule index (newest last) — joined into
    ``/introspect`` and ``obs report``."""
    with _LOCK:
        out = list(_INDEX)
    return out[-k:] if k else out


def reset():
    """Test isolation: clear the index/stats and this thread's capture."""
    with _LOCK:
        _INDEX.clear()
        STATS.update(captures=0, writes=0, skipped_bytes=0)
    _TLS.last = None


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


class Capsule:
    """One loaded capsule: ``meta`` (the JSON header), ``inputs`` and
    ``outputs`` (host numpy dicts), and the source ``path``."""

    def __init__(self, meta: dict, inputs: dict, outputs: dict,
                 path: str | None = None):
        self.meta = meta
        self.inputs = inputs
        self.outputs = outputs
        self.path = path

    @property
    def seam(self) -> str:
        return self.meta.get("seam", "")

    @property
    def engine(self) -> str:
        return (self.meta.get("meta") or {}).get("engine", "")

    def args(self) -> dict:
        """The kernel-arg dict (replay-only ``cf//`` sidecars stripped)."""
        return {k: np.asarray(v) for k, v in self.inputs.items()
                if not k.startswith(CF_PREFIX)}

    def sidecar(self, name: str):
        return self.inputs.get(CF_PREFIX + name)

    def static(self, name: str, default=None):
        return (self.meta.get("meta") or {}).get(name, default)


def load(path: str) -> Capsule:
    """Load + schema-check a capsule file. Forward versions are rejected
    (a capsule written by a NEWER build may carry fields this replayer
    would silently misinterpret — refusing is the only bit-safe answer)."""
    with np.load(path, allow_pickle=False) as z:
        if META_KEY not in z.files:
            raise ValueError(f"{path}: not a replay capsule (no {META_KEY})")
        meta = json.loads(bytes(z[META_KEY]).decode())
        schema = int(meta.get("schema", -1))
        if schema < 1:
            raise ValueError(f"{path}: malformed capsule schema {schema}")
        if schema > SCHEMA_VERSION:
            raise ValueError(
                f"{path}: capsule schema {schema} is newer than this "
                f"build's {SCHEMA_VERSION} — replay with a matching build")
        inputs = {k[len(IN_PREFIX):]: z[k]
                  for k in z.files if k.startswith(IN_PREFIX)}
        outputs = {k[len(OUT_PREFIX):]: z[k]
                   for k in z.files if k.startswith(OUT_PREFIX)}
    return Capsule(meta, inputs, outputs, path)


# ---------------------------------------------------------------------------
# replay engines
# ---------------------------------------------------------------------------

_OUT_KEYS = ("assign", "assign_e", "used", "tmpl", "F")


class _applied_env(envknobs.applied_env):
    """Temporarily apply the capture-time values of selected env knobs
    (mesh partition/repair) so replay reproduces the captured plan — the
    save/apply/restore machinery lives with the other env-knob semantics
    in utils/envknobs.py, the one module of the port that touches the
    process environment."""

    def __init__(self, cap: Capsule, names=_REPLAY_ENV):
        super().__init__(cap.meta.get("env") or {}, names)


# seams whose capture is the chunked counterfactual-row dispatch (shared
# replay body `_run_probe`): the per-candidate probe, the preemption
# counterfactual, the global joint consolidation ladder, and the
# interruption-drain absorb probe
_ROW_SEAMS = ("probe.dispatch", "preempt.dispatch", "global.dispatch",
              "interruption.dispatch")

# the JAX package's rung names that mean another here
_RUNG_ALIASES = {"xla": "device"}


def _rung_name(rung: str | None) -> str | None:
    return _RUNG_ALIASES.get(rung, rung) if rung else rung


def _captured_rung(cap: Capsule) -> str:
    """The replayable rung the capture actually ran."""
    engine = cap.engine
    if cap.seam == "relax.dispatch":
        return "relax"
    if cap.seam in _ROW_SEAMS:
        return "native" if engine == "native" else "device"
    if cap.seam == "mesh.solve":
        return {"partitioned": "partitioned",
                "replicated": "replicated"}.get(engine, "device")
    return {"native": "native"}.get(engine, "device")


def _replay_device(device):
    from karpenter_tpu_torch.ops.kernels import resolve_device

    return resolve_device(device, "capsule replays on the device rung")


def _run_device(cap: Capsule, device) -> dict:
    """The device rung: the capture's numpy arguments through
    ``from_kernel_args`` onto the replay device, ``solve_step`` with the
    captured static parameters (and the captured program's multiply-add
    rule: a service solve folded into a batched dispatch ran the batched
    program's), one int32 buffer back, ``TorchSolver._unpack``."""
    from karpenter_tpu_torch.models.solver import TorchSolver, packed_solve
    from karpenter_tpu_torch.ops import kernels

    args = cap.args()
    max_bins = int(cap.static("max_bins"))
    level_bits = int(cap.static("level_bits", 20))
    if cap.seam == "mesh.solve":
        # the unsharded mesh rung reads max_minv off the args
        max_minv = (int(np.asarray(args["m_minv"]).max())
                    if "m_minv" in args else 0)
    else:
        max_minv = int(cap.static("max_minv", 0))
    flat = packed_solve(
        kernels.from_kernel_args(args, _replay_device(device)), max_bins,
        level_bits, max_minv, fma_rem=not cap.static("batched", False))
    return TorchSolver._unpack(flat.cpu().numpy(), args, max_bins)


def _run_native(cap: Capsule, device=None) -> dict:
    from karpenter_tpu_torch import native

    if not native.available():
        raise ReplayError("native engine unavailable on this host")
    return native.solve_step(cap.args(), int(cap.static("max_bins")))


def _replay_n_shards(cap: Capsule) -> int:
    n = cap.static("n_shards")
    if n:
        return int(n)
    import torch

    return max(torch.cuda.device_count(), 2)


def _run_partitioned(cap: Capsule, device=None) -> dict:
    from karpenter_tpu_torch.parallel.mesh import partitioned_reference

    with _applied_env(cap):
        merged = partitioned_reference(
            cap.args(), int(cap.static("max_bins")), _replay_n_shards(cap),
            level_bits=int(cap.static("level_bits", 20)),
            device=_replay_device(device))
    if merged is None:
        raise ReplayError(
            "snapshot does not partition here (plan refused or repair "
            "overflow) — the partitioned rung is ineligible")
    return {k: np.asarray(v) for k, v in merged.items() if k in _OUT_KEYS}


def _run_replicated(cap: Capsule, device=None) -> dict:
    """The replicated rung offline: over a real >1-card mesh when the
    replay device is CUDA and more than one card is attached, else the
    plain unsharded ``solve_step`` on the replay device — bit-identical by
    the replicated program's contract (parallel/mesh.py)."""
    import torch

    from karpenter_tpu_torch.parallel.mesh import (
        _replicated_solve,
        _to_host,
        make_mesh,
    )

    dev = _replay_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        args = cap.args()
        out = _replicated_solve(
            make_mesh(), args, int(cap.static("max_bins")),
            level_bits=int(cap.static("level_bits", 20)))
        return _to_host(out, _OUT_KEYS)
    return _run_device(cap, dev)


def _run_probe(cap: Capsule, engine: str, device=None) -> dict:
    from karpenter_tpu_torch.ops import consolidate as _cons

    shared = cap.args()
    g_count_k = np.asarray(cap.sidecar("g_count_rows"))
    e_avail = np.asarray(cap.sidecar("e_avail"))
    idx = np.asarray(cap.sidecar("e_zero_idx"))
    lens = np.asarray(cap.sidecar("e_zero_len"))
    e_zero_cols: list = []
    off = 0
    for n in lens.tolist():
        if n < 0:
            e_zero_cols.append(None)
        else:
            e_zero_cols.append(idx[off:off + n])
            off += n
    Gp = int(cap.static("Gp"))
    Ep = int(cap.static("Ep"))
    max_minv = int(cap.static("max_minv", 0))
    # the rows' fresh-claim cap (the joint REPLACE program's); the JAX
    # package's captures do not carry it and ran the m→1 rule
    max_bins = int(cap.static("max_bins", 1))
    e_free = None
    if cap.seam == "preempt.dispatch":
        # the preemption counterfactual's per-row capacity releases:
        # (col, delta[R]) pairs flattened into two sidecars, -1 = None
        cols = np.asarray(cap.sidecar("e_free_col"))
        deltas = np.asarray(cap.sidecar("e_free_delta"))
        e_free = [
            None if int(c) < 0 else (int(c), deltas[i])
            for i, c in enumerate(cols.tolist())
        ]
    if engine == "native":
        from karpenter_tpu_torch import native

        if not native.available():
            raise ReplayError("native engine unavailable on this host")
        placed_g, used = _cons.dispatch_counterfactual_rows_native(
            shared, Gp, Ep, e_avail, max_minv, g_count_k, e_zero_cols,
            e_free=e_free, max_bins=max_bins)
    else:
        from karpenter_tpu_torch.ops import kernels

        placed_g, used = _cons.dispatch_counterfactual_rows(
            kernels.from_kernel_args(shared, _replay_device(device)), Gp, Ep,
            e_avail, max_minv, g_count_k, e_zero_cols, e_free=e_free,
            max_bins=max_bins)
    return {"placed_g": placed_g, "used": used}


# ---------------------------------------------------------------------------
# the relax.dispatch seam's A/B ladder (ops/relax.py): the LP+window
# device decision, the FFD prefix ladder over the SAME counterfactual-row
# sidecars, the host-FFD greedy oracle. All three rungs emit {"k_sel"} —
# the retirement prefix each would pick — so parity_of grades them
# against the captured device selection directly.
# ---------------------------------------------------------------------------


def _run_relax(cap: Capsule, device=None) -> dict:
    from karpenter_tpu_torch.ops.relax import replay_joint

    return replay_joint(cap, _replay_device(device))


def _run_relax_ladder(cap: Capsule, device=None) -> dict:
    """The FFD prefix ladder's verdict on the captured round: dispatch
    the counterfactual rows (``_run_probe`` verbatim — the capture keeps
    the standard row sidecars alongside the LP tensors), then apply the
    shared prefix criterion (coverage + the price gate bits the capture
    pinned) and report the LARGEST feasible prefix."""
    out = _run_probe(cap, "device", device)
    placed_g = np.asarray(out["placed_g"])
    used = np.asarray(out["used"])
    required = np.asarray(cap.sidecar("rx_required"))
    gate = np.asarray(cap.sidecar("rx_claim_gate")).astype(bool)
    G = int(cap.static("rx_g"))
    feasible = (placed_g[:, :G] >= required[:, :G]).all(axis=1)
    feasible &= (np.asarray(used).reshape(-1) == 0) | gate
    ks = np.flatnonzero(feasible) + 1  # row i <-> prefix k=i+1
    ks = ks[ks >= 2]
    return {"k_sel": np.int64(ks.max()) if ks.size else np.int64(0)}


def _run_relax_host(cap: Capsule, device=None) -> dict:
    from karpenter_tpu_torch.ops.relax import replay_host_round

    return replay_host_round(cap)


# ---------------------------------------------------------------------------
# the host-FFD reference (the A/B ladder's bottom rung)
# ---------------------------------------------------------------------------

def _host_feasibility(args: dict) -> np.ndarray:
    """[G,T] bool — numpy mirror of the kernel's group-vs-type feasibility
    (requirement overlap with the Intersects tolerance rule, plus one
    offering jointly satisfying availability + the group's zone/ct allowed
    sets). Chunked over G so a 1024x1024 snapshot stays tens of MB."""
    g_mask = np.asarray(args["g_mask"])
    g_has = np.asarray(args["g_has"])
    g_tol = np.asarray(args.get("g_tol", np.zeros_like(g_has)))
    t_mask = np.asarray(args["t_mask"])
    t_has = np.asarray(args["t_has"])
    t_tol = np.asarray(args.get("t_tol", np.zeros_like(t_has)))
    off_zone = np.asarray(args["off_zone"])
    off_ct = np.asarray(args["off_ct"])
    off_avail = np.asarray(args["off_avail"]).astype(bool)
    gz = np.asarray(args["g_zone_allowed"]).astype(bool)
    gc = np.asarray(args["g_ct_allowed"]).astype(bool)
    G, T = g_mask.shape[0], t_mask.shape[0]
    F = np.zeros((G, T), dtype=bool)
    for lo in range(0, G, 64):
        hi = min(lo + 64, G)
        shared = g_has[lo:hi, None, :] & t_has[None, :, :]
        ov = ((g_mask[lo:hi, None] & t_mask[None, :]) != 0).any(axis=3)
        both = g_tol[lo:hi, None, :] & t_tol[None, :, :]
        req_ok = (~shared | ov | both).all(axis=2)  # [g,T]
        # offerings: any offering available ∧ zone/ct inside the group's
        # allowed sets (-1 = the offering leaves that label undefined)
        z_ok = _off_label_ok(gz[lo:hi], off_zone)
        c_ok = _off_label_ok(gc[lo:hi], off_ct)
        off_ok = (off_avail[None] & z_ok & c_ok).any(axis=2)
        F[lo:hi] = req_ok & off_ok
    return F


def _off_label_ok(allowed: np.ndarray, off_idx: np.ndarray) -> np.ndarray:
    """[g, T, O] bool: per-offering label admissibility — allowed[g, idx]
    where idx >= 0, True where the offering leaves the label undefined."""
    if allowed.shape[1] == 0:
        return np.ones((allowed.shape[0],) + off_idx.shape, dtype=bool)
    idx = np.clip(off_idx, 0, allowed.shape[1] - 1)
    ok = allowed[:, idx]  # [g, T, O]
    return np.where(off_idx[None] >= 0, ok, True)


def _run_host_ffd(cap: Capsule, device=None) -> dict:
    """Pure-numpy first-fit-decreasing over the capsule's tensors: the
    reference algorithm's stance (groups in FFD order, each pod lands on
    the first open bin with a surviving compatible type, new bins open
    from the weight-best template). Informational — the A/B table's
    oracle row; identical-pod groups place in batches exactly like the
    mesh repair pass, so the math mirrors ``_repair_merged``."""
    from karpenter_tpu_torch.parallel.mesh import (
        _EPS,
        _partition_blockers,
        _tmpl_full_rows,
    )

    args = cap.args()
    blocker = _partition_blockers(args)
    if blocker is not None:
        raise ReplayError(f"host-FFD rung ineligible: {blocker}")
    g_count = np.asarray(args["g_count"]).astype(np.int64)
    g_demand = np.asarray(args["g_demand"], dtype=np.float32)
    t_alloc = np.asarray(args["t_alloc"], dtype=np.float32)
    t_tmpl = np.asarray(args["t_tmpl"])
    m_overhead = np.asarray(args["m_overhead"], dtype=np.float32)
    bin_cap = np.asarray(args["g_bin_cap"]) if "g_bin_cap" in args else None
    F = _host_feasibility(args)
    G, T = F.shape
    M = m_overhead.shape[0]
    assign_cols: list = []  # per-bin [G] int32 columns
    loads: list = []
    tmpls: list = []
    typesets: list = []
    for g in range(G):
        n = int(g_count[g])
        if n <= 0:
            continue
        d = g_demand[g]
        pos = d > 0
        if not pos.any():
            continue
        tf = _tmpl_full_rows(args, g)
        for b in range(len(assign_cols)):
            if n <= 0:
                break
            tok = typesets[b] & F[g]
            if not tok.any():
                continue
            adp = t_alloc[:, pos] / d[pos]
            ldp = loads[b][pos] / d[pos]
            room_t = np.floor((adp - ldp[None, :]).min(axis=1)
                              + _EPS).astype(np.int64)
            room_t = np.where(tok, np.maximum(room_t, 0), 0)
            room = int(room_t.max())
            if bin_cap is not None:
                room = min(room, int(bin_cap[g]) - int(assign_cols[b][g]))
            take = min(n, room)
            if take <= 0:
                continue
            assign_cols[b][g] += take
            loads[b] = loads[b] + take * d
            typesets[b] = tok & (room_t >= take)
            n -= take
        while n > 0:
            opened = False
            for m in range(M):
                if not tf[m]:
                    continue
                ovh_ok = (m_overhead[m][None, :] <= t_alloc + _EPS).all(axis=1)
                fresh = t_alloc - m_overhead[m][None, :]
                fr = np.floor((fresh[:, pos] / d[pos]).min(axis=1)
                              + _EPS).astype(np.int64)
                ok_t = F[g] & (t_tmpl == m) & ovh_ok & (fr > 0)
                if not ok_t.any():
                    continue
                per_node = int(fr[ok_t].max())
                if bin_cap is not None:
                    per_node = min(per_node, int(bin_cap[g]))
                if per_node <= 0:
                    continue
                take = min(n, per_node)
                col = np.zeros(G, dtype=np.int32)
                col[g] = take
                assign_cols.append(col)
                loads.append(m_overhead[m] + take * d)
                tmpls.append(m)
                typesets.append(ok_t & (fr >= take))
                n -= take
                opened = True
                break
            if not opened:
                break  # unplaceable remainder — reported via placed totals
    B = max(len(assign_cols), 1)
    assign = (np.stack(assign_cols, axis=1) if assign_cols
              else np.zeros((G, B), dtype=np.int32))
    return {
        "assign": assign,
        "assign_e": np.zeros((G, 1), dtype=np.int32),
        "used": np.arange(assign.shape[1]) < len(assign_cols),
        "tmpl": np.asarray(tmpls + [0] * (B - len(tmpls)), dtype=np.int32),
        "F": F,
    }


# ---------------------------------------------------------------------------
# replay + A/B
# ---------------------------------------------------------------------------

_SOLVE_RUNGS = ("partitioned", "replicated", "device", "native", "host")
_PROBE_RUNGS = ("device", "native")
_RELAX_RUNGS = ("relax", "ladder", "host")


def _execute(cap: Capsule, rung: str, device=None) -> dict:
    if cap.seam == "relax.dispatch":
        return {
            "relax": _run_relax,
            "ladder": _run_relax_ladder,
            "host": _run_relax_host,
        }[rung](cap, device)
    if cap.seam in _ROW_SEAMS:
        return _run_probe(cap, rung, device)
    return {
        "partitioned": _run_partitioned,
        "replicated": _run_replicated,
        "device": _run_device,
        "native": _run_native,
        "host": _run_host_ffd,
    }[rung](cap, device)


def parity_of(captured: dict, out: dict) -> str:
    """Bit-parity grade of a replay against the captured outputs:
    ``exact`` (every shared key bit-equal), ``placed`` (different bin
    axis, but per-group placement totals and used-bin count agree — the
    end-state equivalence the A/B ladder compares), ``differs``."""
    keys = [k for k in captured if k in out]
    if not keys:
        return "differs"
    exact = True
    for k in keys:
        a, b = np.asarray(captured[k]), np.asarray(out[k])
        if a.shape != b.shape or not np.array_equal(a, b):
            exact = False
            break
    if exact:
        return "exact"
    if "placed_g" in captured:  # probe captures have no placement fallback
        return "differs"
    try:
        pa = np.asarray(captured["assign"]).sum(axis=1)
        pb = np.asarray(out["assign"]).sum(axis=1)
        if "assign_e" in captured and "assign_e" in out:
            pa = pa + np.asarray(captured["assign_e"]).sum(axis=1)
            pb = pb + np.asarray(out["assign_e"]).sum(axis=1)
        ua = int(np.asarray(captured["used"]).sum())
        ub = int(np.asarray(out["used"]).sum())
        if pa.shape == pb.shape and np.array_equal(pa, pb) and ua == ub:
            return "placed"
    except (KeyError, ValueError):
        pass
    return "differs"


def _nodes_of(out: dict) -> int | None:
    if "used" in out:
        return int(np.asarray(out["used"]).sum())
    return None


def replay(cap: Capsule, rung: str | None = None, device=None) -> dict:
    """Re-execute the capture (on its own rung unless overridden; ``xla``
    means ``device``) and grade the result against the captured outputs.
    The device rung runs on ``device`` (CUDA when None; it raises without
    a card). Returns ``{rung, parity, ms, nodes, captured_rung,
    rung_match}``."""
    want = _rung_name(rung) or _captured_rung(cap)
    t0 = time.perf_counter()
    out = _execute(cap, want, device)
    ms = (time.perf_counter() - t0) * 1000.0
    return {
        "rung": want,
        "captured_rung": _captured_rung(cap),
        "rung_match": want == _captured_rung(cap),
        "parity": parity_of(cap.outputs, out),
        "ms": round(ms, 2),
        "nodes": _nodes_of(out),
        "captured_nodes": _nodes_of(cap.outputs),
    }


def ab_compare(cap: Capsule, device=None) -> list:
    """Run the capsule across every eligible rung; one row per rung with
    parity vs the captured outputs, node count, wall clock, and the
    decision diff vs the captured rung. Ineligible/failed rungs report
    why instead of silently vanishing (the mesh rungs name the ROADMAP
    item that brings them)."""
    if cap.seam == "relax.dispatch":
        rungs: tuple = _RELAX_RUNGS
    elif cap.seam in _ROW_SEAMS:
        rungs = _PROBE_RUNGS
    else:
        rungs = _SOLVE_RUNGS
    rows = []
    for rung in rungs:
        try:
            t0 = time.perf_counter()
            out = _execute(cap, rung, device)
            ms = (time.perf_counter() - t0) * 1000.0
        except ReplayError as e:
            rows.append({"rung": rung, "eligible": False, "why": str(e)})
            continue
        except Exception as e:  # a rung crashing must not kill the table
            rows.append({"rung": rung, "eligible": False,
                         "why": f"{type(e).__name__}: {e}"})
            continue
        rows.append({
            "rung": rung,
            "eligible": True,
            "parity": parity_of(cap.outputs, out),
            "nodes": _nodes_of(out),
            "ms": round(ms, 2),
            "captured_rung": _captured_rung(cap),
            "rung_match": rung == _captured_rung(cap),
        })
    return rows
