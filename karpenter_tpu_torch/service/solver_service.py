"""gRPC solver service: the device plane as a standalone, multi-tenant
fleet service.

The port's copy of ``karpenter_tpu/service/solver_service.py``: the same
wire contract, sessions, coalescer and SLO surfaces, so a client of one
package talks to the server of the other. The server runs the port's
``TorchSolver`` on the card (``--device cpu`` for the plain path,
``--native`` for the C++ engine) and folds coalesced windows into
``models/solver.py`` ``batched_invoke``. The client, ``RemoteSolver``,
ships the numpy kernel arguments from ``TorchSolver._dispatch`` and never
uploads anything to a device; its own ``device`` (the CPU by default)
runs only the LP floor of its bin-axis plan and the in-process rescue.

Wire contract (raw-bytes unary RPCs, no generated stubs):

- ``/karpenter.Solver/Solve`` — the stateless seam: request is an
  .npz archive of the kernel's tensor snapshot (the exact numpy args dict
  ``TorchSolver._dispatch`` takes) plus a ``__meta__`` JSON entry carrying
  the static solve parameters (max_bins, level_bits, max_minv); response
  is an .npz archive of the kernel outputs (assign/assign_e/used/tmpl/F).
- ``/karpenter.Solver/Register`` — open a tenant session: meta
  ``{tenant}`` in, ``{session, ttl_s, inflight}`` out.
- ``/karpenter.Solver/SessionSolve`` — the streaming delta protocol
  (deploy/README.md "Multi-tenant solver service"): the first request of a
  session ships ``mode=full`` (the whole snapshot, optionally compressed
  under ``KARPENTER_SOLVER_COMPRESS``); every later round ships
  ``mode=delta`` — only the arrays that changed, row-spliced
  (``<key>//rows`` + ``<key>//vals``) where the leading axis moved
  sparsely — plus the cluster journal window
  (``state/cluster.py Cluster.export_deltas``) as provenance. The server
  maintains the per-tenant bundle (service/session.py) with the same
  in-place row-splice primitive the in-process disruption snapshot uses,
  and demands a full resync (FAILED_PRECONDITION, class name in the
  status details) on a journal gap, an opaque entry, an evicted bundle,
  or a patch whose shapes mismatch the cached family; out-of-order seqs
  are rejected outright. The client keys its session state per shape
  family (every array's name/shape/dtype) — a solve mix that alternates
  families (provisioning vs confirm sub-solves, the doubled bin axis)
  holds one session per family and rides deltas on each, instead of
  re-shipping the world on every flip.

The server executes on the card by default
(`python -m karpenter_tpu_torch.service.solver_service`), on the CPU or the
C++ engine when asked, while the client process needs no card.
Concurrent same-shape solves (any mix of tenants) fold into one device
dispatch under the coalescing window
(service/coalesce.py, ``KARPENTER_COALESCE_WINDOW_MS``), and per-tenant
admission budgets (``KARPENTER_TENANT_INFLIGHT``) convert overload into
backpressure instead of unbounded queueing.

Cross-boundary SLO tracing (deploy/README.md "Device-plane & SLO
telemetry"): the client threads its open round's trace id through the
``__meta__`` payload (`trace_id`), and the server opens one linked round
trace per request (`solver-service`, `client_trace=<id>`,
`tenant=<id>` on session solves) so a grep for the client's trace id
finds both halves of the hop. Request durations feed
``karpenter_solver_request_seconds{outcome}`` plus the rolling-quantile/
error-budget SLO tracker (obs/devplane.py) — tenant-labeled on session
solves — that the metrics server's ``/slo`` endpoint snapshots; a
server-side solve failure aborts the RPC with the root-cause exception
class in the status details, which the client surfaces as the ``reason``
label on ``karpenter_solver_remote_fallbacks_total`` and in its
structured warning.

The RPC bodies import ``grpc`` only on their abort paths, so a handler
serves bytes in and bytes out in a process without grpc.
"""

from __future__ import annotations

import io
import json
from collections import OrderedDict

import numpy as np

from karpenter_tpu_torch.utils.envknobs import env_str

_METHOD = "/karpenter.Solver/Solve"
_METHOD_REGISTER = "/karpenter.Solver/Register"
_METHOD_SESSION = "/karpenter.Solver/SessionSolve"
_MAX_MSG = 256 * 1024 * 1024  # the 50k snapshot is ~tens of MB uncompressed
_GRPC_OPTS = [
    ("grpc.max_send_message_length", _MAX_MSG),
    ("grpc.max_receive_message_length", _MAX_MSG),
]

# the zstd frame magic (RFC 8878): a compressed payload is detected by
# prefix, so the wire needs no codec negotiation
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _env_codec() -> str | None:
    """KARPENTER_SOLVER_COMPRESS: off by default; ``1``/``npz``/``deflate``
    compresses full-snapshot payloads with numpy's deflate zip
    (savez_compressed — transparent to np.load); ``zstd`` uses zstandard
    when importable CLIENT-side, falling back to deflate (the container
    bakes no new deps). Decompression happens SERVER-side: session
    clients learn the server's codecs at Register and downgrade to
    deflate when the server can't read zstd frames; the stateless Solve
    path has no handshake, so only use zstd there when both images carry
    zstandard."""
    from karpenter_tpu_torch.service.session import env_bool

    v = (env_str("KARPENTER_SOLVER_COMPRESS", "") or "").strip().lower()
    if not env_bool("KARPENTER_SOLVER_COMPRESS", False):
        return None
    if v == "zstd":
        try:
            import zstandard  # noqa: F401

            return "zstd"
        except ImportError:
            return "deflate"
    return "deflate"


def _server_codecs() -> list:
    """Codecs this process can DECODE (the Register handshake's body)."""
    out = ["deflate"]
    try:
        import zstandard  # noqa: F401

        out.append("zstd")
    except ImportError:
        pass
    return out


def _pack(arrays: dict, meta: dict, codec: str | None = None) -> bytes:
    buf = io.BytesIO()
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    if codec == "deflate":
        np.savez_compressed(buf, **payload)
    else:
        np.savez(buf, **payload)
    blob = buf.getvalue()
    if codec == "zstd":
        import zstandard

        blob = zstandard.ZstdCompressor().compress(blob)
    return blob


def _unpack(blob: bytes) -> tuple:
    if blob[:4] == _ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError as e:
            # name the misconfiguration instead of a bare ImportError: the
            # peer compressed with zstd this process cannot read
            raise RuntimeError(
                "zstd-compressed payload but the zstandard package is not "
                "importable here (KARPENTER_SOLVER_COMPRESS=zstd needs it "
                "on BOTH sides; session clients auto-downgrade via the "
                "Register handshake)") from e
        blob = zstandard.ZstdDecompressor().decompress(blob)
    with np.load(io.BytesIO(blob)) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z.files else {}
    return arrays, meta


def _env_latency_slo() -> float | None:
    """KARPENTER_SOLVER_SLO_MS: per-request latency objective in ms
    (unset = error-only SLO)."""
    v = (env_str("KARPENTER_SOLVER_SLO_MS", "") or "").strip()
    if not v:
        return None
    try:
        return float(v) / 1000.0
    except ValueError:
        return None


class _SolverHandler:
    """Server-side execution through the solver's own ``_dispatch``: the
    engine gates (small batches to the native engine) and the device
    solve (one device→host read) apply on the serving side exactly as
    in-process. Every request runs as
    one linked round trace and lands in the service SLO tracker; session
    solves additionally ride the per-tenant snapshot cache, the
    coalescer, and the admission budget."""

    def __init__(self, use_native: bool = False, registry=None,
                 device=None):
        from karpenter_tpu_torch.models.solver import NativeSolver, TorchSolver
        from karpenter_tpu_torch.obs import devplane
        from karpenter_tpu_torch.operator import metrics as _metrics
        from karpenter_tpu_torch.service.coalesce import Coalescer, coalesce_window_s
        from karpenter_tpu_torch.service.session import SessionRegistry

        # the card unless the caller names a device (TorchSolver raises
        # without one); the native server's device runs nothing
        self._solver = (NativeSolver(device=device or "cpu") if use_native
                        else TorchSolver(device=device))
        self._registry = registry if registry is not None else _metrics.REGISTRY
        self._slo = devplane.slo_tracker(
            "solver_service", latency_slo=_env_latency_slo()
        )
        self.sessions = SessionRegistry()
        # sweep-driven session GC: a periodic sweep releases expired
        # sessions' bundle bytes from the LRU budget instead of waiting
        # for a client access to trip the reap (an idle expired tenant
        # would otherwise squat its multi-MB bundle for as long as nobody
        # touched the server). KARPENTER_SESSION_SWEEP_S=0 disables.
        self._sweeper_stop = self.sessions.start_sweeper(
            registry=self._registry)
        window = coalesce_window_s()
        self._coalescer = None
        self._cpu_pool = None
        if window > 0 and not use_native:
            from concurrent.futures import ThreadPoolExecutor

            # CPU-path fan-out pool for coalesced windows, built once: a
            # fresh executor per batch would put thread spawn/join churn
            # on the serving hot path the coalescer exists to bound (the
            # pool's threads spawn lazily, so an accelerated server that
            # never takes the CPU branch pays only for this object)
            self._cpu_pool = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="solver-cpu-fold")
            # folding needs the batched device solve; the pure-native
            # server keeps per-request dispatch (its engine is a
            # sequential loop — stacking buys nothing)
            self._coalescer = Coalescer(
                dispatch_one=self._dispatch_one,
                dispatch_many=self._dispatch_many,
                window_s=window,
                registry=self._registry,
            )

    # -- dispatch (shared by Solve and SessionSolve) ---------------------

    def _dispatch_one(self, item: dict):
        out = self._solver._dispatch(
            item["args"], item["key"], item["max_bins"])
        # the engine THIS dispatch ran, read on the dispatching thread
        # (the solver's engine slot is thread-local): the replay capture
        # must never stamp another tenant's rung onto this item
        item["engine"] = engines.capture_engine(self._solver._engine)
        return out

    def _dispatch_many(self, items: list):
        # on the card the fold rides ONE batched dispatch (the shape family
        # the window exists to share); off an accelerator (engines'
        # test) the batched plain path loses to the per-request engine at
        # every size, so the members dispatch concurrently (the native
        # engine's ctypes call releases the GIL: a k-fold costs ~1 solve)
        if not engines.accelerated(self._solver.device):
            if len(items) == 1:
                return [self._dispatch_one(items[0])]
            return list(self._cpu_pool.map(self._dispatch_one, items))
        # the engine gates first, as in process: a member they send to the
        # native engine runs there, on the fan-out pool, so folding never
        # changes a member's engine; only the device-routed rest is folded
        folded = [i for i, it in enumerate(items)
                  if self._solver.native_reason(it["args"]) is None]
        if len(folded) < 2:
            return list(self._cpu_pool.map(self._dispatch_one, items))
        pending = {i: self._cpu_pool.submit(self._dispatch_one, items[i])
                   for i in range(len(items)) if i not in folded}
        first = items[folded[0]]
        for i in folded:
            # the batched fold IS the device path, under the batched
            # program's multiply-add rule (the capture says so)
            items[i]["engine"] = "device"
            items[i]["batched"] = True
        outs = dict(zip(folded, batched_invoke(
            [items[i]["args"] for i in folded], first["max_bins"],
            level_bits=first["key"][-2], max_minv=first["key"][-1],
            device=self._solver.device)))
        outs.update({i: f.result() for i, f in pending.items()})
        return [outs[i] for i in range(len(items))]

    def _dispatch(self, args: dict, key: tuple, max_bins: int):
        """Returns ``(outputs, item)`` — the engine rides the item dict
        (set by whichever thread actually dispatched it, before the
        coalescer hands the result back), so the replay capture is exact
        even for folded/concurrent requests."""
        item = {"args": args, "key": key, "max_bins": max_bins}
        if self._coalescer is None:
            out = self._dispatch_one(item)
        else:
            # bucket = the executable identity: static params + every
            # array's padded shape/dtype — exactly what the compile ledger
            # keys on, so folded requests share one compiled program by
            # construction
            bucket = (
                max_bins, key[-2], key[-1],
                tuple(sorted(
                    (k, np.asarray(v).shape, np.asarray(v).dtype.str)
                    for k, v in args.items()
                )),
            )
            out = self._coalescer.submit(bucket, item)
        return out, item

    def close(self):
        """Release background resources: stop the session sweeper and the
        CPU fan-out pool. Wired into the server's stop() so an in-process
        service (tests, perf) does not leak a waking thread per
        instance."""
        if self._sweeper_stop is not None:
            self._sweeper_stop.set()
        if self._cpu_pool is not None:
            self._cpu_pool.shutdown(wait=False)

    @staticmethod
    def _outputs(out: dict) -> dict:
        return {k: np.asarray(out[k])
                for k in ("assign", "assign_e", "used", "tmpl", "F")}

    def _capture(self, args, key, max_bins, out, item, tenant=None):
        """Service-boundary replay capture (obs/capsule.py): attached to
        the server's open round trace, tenant-scoped on session solves —
        an anomalous serving round yields a capsule replayable offline
        with the exact tensors this tenant shipped. The engine is the
        per-item one `_dispatch` threads back (never the shared solver's
        slot — a concurrent tenant's rung must not leak in); a row of a
        batched dispatch records ``batched`` so its replay runs the
        batched program's multiply-add rule."""
        from karpenter_tpu_torch.obs import capsule as _capsule

        if not _capsule.capture_enabled():
            return
        extra = {"batched": True} if item.get("batched") else {}
        _capsule.record_capture(
            "service.solve", args, self._outputs(out), tenant=tenant,
            engine=item.get("engine", "device"),
            max_bins=int(max_bins), level_bits=int(key[-2]),
            max_minv=int(key[-1]), **extra)

    # -- RPC bodies ------------------------------------------------------

    def solve(self, request: bytes, context) -> bytes:
        import time

        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.operator.logging import root_cause

        t0 = time.perf_counter()
        outcome = "ok"
        try:
            args, meta = _unpack(request)
            max_bins = int(meta["max_bins"])
            # _dispatch reads only the key's tail: (..., level_bits,
            # max_minv) — the same layout models/solver.py builds
            key = (max_bins, int(meta.get("level_bits", 20)),
                   int(meta.get("max_minv", 0)))
            # the server half of the cross-boundary trace: a round of its
            # own, linked to the client's reconcile round by trace id
            with obs.round_trace("solver-service", registry=self._registry,
                                 client_trace=meta.get("trace_id") or None):
                out, item = self._dispatch(args, key, max_bins)
                self._capture(args, key, max_bins, out, item)
            return _pack(self._outputs(out), {})
        except Exception as e:
            import grpc

            outcome = "error"
            # the client's fallback attributes its rescue to this class:
            # ship the root cause in the status details, not just a string
            context.abort(grpc.StatusCode.INTERNAL,
                          f"{root_cause(e)}: {e}")
        finally:
            self._slo.observe(time.perf_counter() - t0, outcome=outcome,
                              registry=self._registry)

    def register(self, request: bytes, context) -> bytes:
        _, meta = _unpack(request)
        tenant = str(meta.get("tenant") or "")
        try:
            sess = self.sessions.register(tenant, registry=self._registry)
        except ValueError as e:
            import grpc

            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"ValueError: {e}")
        # a client re-registering after a seq-fence break (or evicting a
        # shape family client-side) names the sessions it abandoned:
        # release their bundles from the LRU budget immediately instead of
        # letting orphans squat until the TTL reaper (where they would
        # evict healthy tenants' bundles)
        stale = meta.get("supersedes")
        if stale:
            for sid in [stale] if isinstance(stale, str) else stale:
                self.sessions.release(str(sid), tenant,
                                      registry=self._registry)
        return _pack({}, {
            "session": sess.id,
            "ttl_s": self.sessions.ttl_s,
            "inflight": self.sessions.inflight_budget,
            # codec negotiation: compression is chosen client-side but
            # DECOMPRESSED server-side — the client downgrades to deflate
            # when this server cannot read zstd frames
            "codecs": _server_codecs(),
        })

    def session_solve(self, request: bytes, context) -> bytes:
        import time

        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.operator.logging import root_cause
        from karpenter_tpu_torch.service import session as sess_mod

        t0 = time.perf_counter()
        outcome = "ok"
        tenant = None
        try:
            arrays, meta = _unpack(request)
            sess = self.sessions.lookup(str(meta.get("session", "")),
                                        registry=self._registry)
            tenant = sess.tenant
            max_bins = int(meta["max_bins"])
            key = (max_bins, int(meta.get("level_bits", 20)),
                   int(meta.get("max_minv", 0)))
            with self.sessions.admit(sess, registry=self._registry):
                args = self.sessions.apply(sess, arrays, meta,
                                           registry=self._registry)
                self.sessions.drain_evictions(registry=self._registry)
                with obs.round_trace(
                    "solver-service", registry=self._registry,
                    client_trace=meta.get("trace_id") or None,
                    tenant=tenant,
                ):
                    # the server half of the session.sync decision ledger:
                    # one tenant-labeled verdict per request, feeding the
                    # /introspect per-tenant rung mix (the client records
                    # its own half in its process). Full-upload reasons
                    # ride the client's `sync_reason` meta, clamped into
                    # the site's closed enum.
                    from karpenter_tpu_torch.obs import decisions

                    if meta.get("mode") == "delta":
                        decisions.record_decision(
                            "session.sync", "delta",
                            registry=self._registry, tenant=tenant)
                    else:
                        decisions.record_decision(
                            "session.sync", "resync",
                            meta.get("sync_reason") or "initial",
                            registry=self._registry, tenant=tenant)
                    out, item = self._dispatch(args, key, max_bins)
                    self._capture(args, key, max_bins, out, item,
                                  tenant=tenant)
            return _pack(self._outputs(out), {
                "mode": meta.get("mode", "full"),
                "full_uploads": sess.full_uploads,
                "delta_rounds": sess.delta_rounds,
            })
        except sess_mod.SessionError as e:
            import grpc

            # protocol renegotiation (resync demands) is not a server
            # failure; admission/ordering rejections are — the SLO tracker
            # burns budget for `rejected`/`error` only
            outcome = (
                "resync"
                if isinstance(e, (sess_mod.ResyncRequired,
                                  sess_mod.SessionExpired,
                                  sess_mod.UnknownSession))
                else "rejected"
            )
            context.abort(getattr(grpc.StatusCode, e.status),
                          f"{type(e).__name__}: {e}")
        except Exception as e:
            import grpc

            outcome = "error"
            context.abort(grpc.StatusCode.INTERNAL,
                          f"{root_cause(e)}: {e}")
        finally:
            self._slo.observe(time.perf_counter() - t0, outcome=outcome,
                              registry=self._registry, tenant=tenant)


def serve(port: int = 0, use_native: bool = False, max_workers: int = 4,
          host: str = "127.0.0.1", registry=None, device=None):
    """Start the device-plane server; returns (grpc.Server, bound_port).
    The solver runs on ``device`` (the card when None; it raises without
    one — pass ``device="cpu"`` for the plain path).
    Default bind is loopback (tests, local splits); containerized deploys
    pass host="0.0.0.0" so the pod IP is reachable (deploy/operator.yaml).
    `registry` homes the request/SLO families (default: the process
    registry the standalone entrypoint's metrics server exposes).
    KARPENTER_SOLVER_WORKERS overrides the worker pool for multi-tenant
    fleets."""
    from concurrent import futures

    import grpc

    from karpenter_tpu_torch.service.session import env_int

    max_workers = env_int("KARPENTER_SOLVER_WORKERS", max_workers,
                          minimum=1)

    handler = _SolverHandler(use_native=use_native, registry=registry,
                             device=device)

    class _Generic(grpc.GenericRpcHandler):
        def service(self, call_details):
            body = {
                _METHOD: handler.solve,
                _METHOD_REGISTER: handler.register,
                _METHOD_SESSION: handler.session_solve,
            }.get(call_details.method)
            if body is not None:
                return grpc.unary_unary_rpc_method_handler(
                    body,
                    request_deserializer=None,  # raw bytes both ways
                    response_serializer=None,
                )
            return None

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers), options=_GRPC_OPTS
    )
    server.add_generic_rpc_handlers((_Generic(),))
    # exposed for tests (fault injection on the serving solver) and for
    # embedding callers that want the SLO tracker / session registry
    server.solver_handler = handler
    # stop() must also release the handler's background resources (the
    # session sweeper thread, the CPU fan-out pool): grpc's stop knows
    # nothing about them, so wrap it
    _grpc_stop = server.stop

    def _stop(grace=None):
        handler.close()
        return _grpc_stop(grace)

    server.stop = _stop
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise RuntimeError(f"solver service: failed to bind {host}:{port}")
    server.start()
    return server, bound


from karpenter_tpu_torch.models.solver import TorchSolver, batched_invoke  # noqa: E402
from karpenter_tpu_torch.ops import engines  # noqa: E402

# distinct shape families one client keeps live sessions for: the base
# family plus the doubled bin-axis re-run covers steady state; growth
# families displace the LRU entry (its server session is released on the
# next Register, or TTL-reaped)
_FAMILY_CAP = 4


class _FamilyState:
    """Client-side session state for ONE shape family (every array's
    name/shape/dtype): the server holds one bundle per session, so each
    family the solver dispatches needs its own session to ride deltas."""

    __slots__ = ("session_id", "seq", "sent", "sent_generation", "stale")

    def __init__(self):
        self.session_id: str | None = None
        self.seq = 0
        self.sent: dict | None = None  # last acked args
        self.sent_generation = 0
        self.stale: str | None = None  # abandoned id, released on Register

# transient transport failures worth ONE bounded retry with jittered
# backoff before the in-process rescue: the service restarting or a
# deadline blip is not a dead device plane
_RETRYABLE_CODES = ("UNAVAILABLE", "DEADLINE_EXCEEDED")


class RemoteSolver(TorchSolver):
    """Drop-in Solver whose kernel dispatch crosses the gRPC boundary:
    tensorize/decode/validation stay host-side, exactly one round trip per
    dispatch (the in-process ``_dispatch`` seam on the numpy arguments,
    served remotely; nothing is uploaded to a device here). ``device``
    (the CPU by default, so the client needs no card) runs the LP floor
    of the bin-axis plan and the in-process rescue.

    Two dispatch modes. The default stateless mode ships the whole tensor
    snapshot per solve. Passing ``tenant=`` turns on SESSION mode — the
    streaming delta protocol: register once, ship one full snapshot, then
    ship per-round deltas (changed arrays, row-spliced where sparse) with
    the cluster journal window as provenance (``bind_cluster`` wires the
    journal; the Environment does it automatically). The server answers
    protocol drift (gap/opaque/eviction/expiry) with a resync demand and
    the client re-ships a full snapshot exactly once — counted under
    ``karpenter_solver_session_resyncs_total{reason}``.

    Transient transport errors (UNAVAILABLE/DEADLINE_EXCEEDED) get one
    bounded retry with jittered backoff (KARPENTER_SOLVER_RETRY_MS base;
    KARPENTER_SOLVER_RETRY=0 disables) before the in-process rescue; the
    fallback reason then reads ``transport-retryable``, distinguishing a
    flapping service from a server-side solve error (exception class) or
    a hard transport fault (``transport``). Every in-process rescue
    increments `karpenter_solver_remote_fallbacks_total` (labeled by gRPC
    status code + reason) in the injected registry and emits a structured
    warn on the logging plane — a dead device plane shows up on the
    scrape and in grep, not only in throughput."""

    def __init__(self, target: str, registry=None, log=None,
                 tenant: str | None = None, device="cpu"):
        import grpc

        from karpenter_tpu_torch.operator import metrics as _metrics
        from karpenter_tpu_torch.operator.logging import make_logger

        super().__init__(device=device)
        self._target = target
        self._registry = registry if registry is not None else _metrics.REGISTRY
        self._log = (log if log is not None else make_logger()).with_values(
            component="remote_solver", target=target
        )
        self._channel = grpc.insecure_channel(target, options=_GRPC_OPTS)
        self._call = self._channel.unary_unary(
            _METHOD, request_serializer=None, response_deserializer=None
        )
        self._call_register = self._channel.unary_unary(
            _METHOD_REGISTER, request_serializer=None,
            response_deserializer=None
        )
        self._call_session = self._channel.unary_unary(
            _METHOD_SESSION, request_serializer=None,
            response_deserializer=None
        )
        # session-mode state: ONE server session per shape family. A solve
        # can dispatch more than one family (the doubled bin-axis re-run
        # when the bin estimate runs dry), and the server holds exactly one
        # bundle per session — a single shared snapshot slot would make
        # every family flip ship a full upload miscounted as a resync,
        # while per-family sessions pay one full upload per family once
        # and ride deltas thereafter.
        self._tenant = tenant
        self._cluster = None
        self._families: "OrderedDict[tuple, _FamilyState]" = OrderedDict()
        self._released: list = []  # evicted families' ids, freed on Register
        # accounting the perf harness reads back per tenant
        self.session_stats = {
            "full_uploads": 0, "delta_rounds": 0, "resyncs": 0,
            "retries": 0, "bytes_full": 0, "bytes_delta": 0,
        }

    def bind_observability(self, registry=None, log=None):
        """Re-home the fallback counter/log onto an Environment's registry
        and logging plane. The operator builds the solver BEFORE the
        Environment (the solver is a constructor arg), so __main__ binds
        here afterwards — otherwise fallbacks would count in the global
        registry, which serve_metrics never exposes."""
        if registry is not None:
            self._registry = registry
        if log is not None:
            self._log = log.with_values(
                component="remote_solver", target=self._target
            )

    def bind_cluster(self, cluster):
        """Wire the cluster whose delta journal provides the session
        protocol's provenance window (gap/opaque detection rides
        ``Cluster.export_deltas``). Sessionless solvers ignore it."""
        self._cluster = cluster

    # -- transport helpers ----------------------------------------------

    @staticmethod
    def _fallback_reason(e) -> str:
        """Root-cause label for a rescued dispatch: a server-side abort
        carries `ExceptionClass: detail` in the status details (the
        handler's contract); anything else is a transport failure."""
        try:
            details = e.details() or ""
        except Exception:
            details = ""
        head = details.split(":", 1)[0].strip()
        return head if head.isidentifier() else "transport"

    @staticmethod
    def _retryable(e) -> bool:
        try:
            return getattr(e.code(), "name", "") in _RETRYABLE_CODES
        except Exception:
            return False

    @staticmethod
    def _retry_base_s() -> float:
        from karpenter_tpu_torch.service.session import env_float

        return env_float("KARPENTER_SOLVER_RETRY_MS", 50.0,
                         minimum=0.0) / 1000.0

    def _call_with_retry(self, call, payload: bytes) -> bytes:
        import grpc

        from karpenter_tpu_torch.operator import metrics as _metrics

        try:
            return call(payload)
        except grpc.RpcError as e:
            from karpenter_tpu_torch.service.session import env_bool

            if (not env_bool("KARPENTER_SOLVER_RETRY", True)
                    or not self._retryable(e)):
                raise
            import random
            import time as _time

            delay = self._retry_base_s() * (0.5 + random.random())
            _time.sleep(delay)
            self.session_stats["retries"] += 1
            try:
                code = str(e.code())
            except Exception:
                code = "UNKNOWN"
            self._registry.counter(
                _metrics.SOLVER_REMOTE_RETRIES,
                "transient-transport retries before the in-process rescue",
            ).inc(code=code)
            self._log.warn("transient solver-service error; retrying once",
                           code=code, delay_ms=round(delay * 1000.0, 1))
            return call(payload)

    def _fallback(self, e, args, key, max_bins, upload=None):
        """Solve in-process rather than failing the provisioning round
        (the Solver seam's fallback stance, as the engine ladder's),
        attributing the rescue to its root cause: server exception class, retried-and-still-down transport
        (`transport-retryable`), or hard transport."""
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.operator import metrics as _metrics

        try:
            code = str(e.code())
        except Exception:
            code = "UNKNOWN"
        reason = self._fallback_reason(e)
        if reason == "transport" and self._retryable(e):
            reason = "transport-retryable"
        # bounded label cardinality (the decision-ledger stance): a server
        # exception class outside the known set clamps to "server-error"
        # instead of minting a fresh series per novel bug
        from karpenter_tpu_torch.obs import decisions

        if reason not in decisions.SOLVER_FALLBACK_REASONS:
            reason = "server-error"
        trace_id = obs.current_trace_id()
        self._registry.counter(
            _metrics.SOLVER_REMOTE_FALLBACKS,
            "RemoteSolver dispatches rescued by the in-process kernel",
        ).inc(code=code, reason=reason)
        self._log.warn("solver service unavailable; solving in-process",
                       code=code, reason=reason, trace=trace_id or "")
        out = super()._dispatch(args, key, max_bins, upload)
        if self._route is not None:
            # the solve's solver.route verdict keeps the in-process rung
            # the rescue actually ran, but the REASON says why it left the
            # service rung — the downgrade is visible on the ledger
            self._route = (self._route[0], "remote-fallback")
        return out

    def _record_payload(self, kind: str, nbytes: int, codec: str | None):
        from karpenter_tpu_torch.operator import metrics as _metrics

        self.session_stats[f"bytes_{kind}"] = (
            self.session_stats.get(f"bytes_{kind}", 0) + nbytes)
        self._registry.histogram(
            _metrics.SOLVER_REQUEST_BYTES,
            "wire payload sizes by kind and codec",
            buckets=_metrics.SOLVER_REQUEST_BYTES_BUCKETS,
        ).observe(nbytes, kind=kind, codec=codec or "none")

    # -- dispatch --------------------------------------------------------

    def _dispatch(self, args, key, max_bins, upload=None):
        import grpc

        from karpenter_tpu_torch import obs

        trace_id = obs.current_trace_id()
        meta = {"max_bins": int(max_bins), "level_bits": int(key[-2]),
                "max_minv": int(key[-1]), "trace_id": trace_id or ""}
        try:
            if self._tenant is None:
                codec = _env_codec()
                payload = _pack(dict(args), meta, codec=codec)
                self._record_payload("full", len(payload), codec)
                blob = self._call_with_retry(self._call, payload)
            else:
                blob = self._session_round(args, meta)
        except grpc.RpcError as e:
            return self._fallback(e, args, key, max_bins, upload)
        self._engine = "remote"
        self._route = ("service", "ok")
        arrays, _ = _unpack(blob)
        arrays["used"] = arrays["used"].astype(bool)
        arrays["F"] = arrays["F"].astype(bool)
        return arrays

    # -- session mode ----------------------------------------------------

    def _count_resync(self, reason: str):
        from karpenter_tpu_torch.obs import decisions
        from karpenter_tpu_torch.operator import metrics as _metrics

        self.session_stats["resyncs"] += 1
        self._registry.counter(
            _metrics.SOLVER_SESSION_RESYNCS,
            "session full re-uploads by cause (journal gaps, opaque "
            "deltas, server resync demands)",
        ).inc(
            # the label universe IS the session.sync decision enum: a new
            # server error class can never mint an unbounded series here
            # while the ledger stays closed (obs/decisions.py)
            reason=decisions.canonical_reason("session.sync", reason))

    def _register_session(self, st: _FamilyState):
        req: dict = {"tenant": self._tenant}
        stale = list(self._released)
        if st.stale is not None:
            stale.append(st.stale)
        if stale:
            req["supersedes"] = stale
        blob = self._call_with_retry(
            self._call_register, _pack({}, req))
        _, meta = _unpack(blob)
        st.stale = None
        self._released.clear()
        st.session_id = meta["session"]
        self._server_codecs = set(meta.get("codecs") or ["deflate"])
        st.seq = 0
        st.sent = None
        st.sent_generation = 0

    def _upload_codec(self) -> str | None:
        """The configured codec, downgraded to what the server can read
        (the Register handshake's `codecs`)."""
        codec = _env_codec()
        if codec == "zstd" and "zstd" not in getattr(
                self, "_server_codecs", {"deflate", "zstd"}):
            return "deflate"
        return codec

    # -- per-family session state (tests read the properties) ------------

    def _family_state(self, args) -> _FamilyState:
        """The session state for this dispatch's shape family, created on
        first sight; the LRU family beyond the cap is evicted and its
        server session queued for release on the next Register."""
        key = tuple(sorted(
            (k, v.shape, str(v.dtype)) for k, v in args.items()))
        st = self._families.pop(key, None)
        if st is None:
            st = _FamilyState()
            while len(self._families) >= _FAMILY_CAP:
                _, old = self._families.popitem(last=False)
                if old.session_id is not None:
                    self._released.append(old.session_id)
        self._families[key] = st  # most-recently-used at the end
        return st

    @property
    def _session_id(self):
        st = next(reversed(self._families.values()), None)
        return st.session_id if st is not None else None

    @property
    def _session_seq(self):
        st = next(reversed(self._families.values()), None)
        return st.seq if st is not None else 0

    def _session_round(self, args, meta_base: dict) -> bytes:
        """One solve over the session protocol: build the smallest payload
        the session state allows (delta when the server holds our last
        snapshot, full otherwise), and answer exactly ONE server resync
        demand with a full re-upload before giving up to the caller's
        fallback."""
        import grpc

        from karpenter_tpu_torch.obs import decisions

        args = {k: np.asarray(v) for k, v in args.items()}
        st = self._family_state(args)
        payload, pending = self._session_payload(args, meta_base, st)
        try:
            blob = self._call_with_retry(self._call_session, payload)
        except grpc.RpcError as e:
            head = self._fallback_reason(e)
            if head not in ("ResyncRequired", "SessionExpired",
                            "UnknownSession", "OutOfOrderDelta"):
                raise
            self._count_resync(head)
            if head != "ResyncRequired":
                # expiry/unknown: re-register. Out-of-order: the server's
                # seq fence is ahead of ours (a retry that actually landed)
                # — a fresh session is cheaper than guessing its fence.
                # The abandoned session may still be LIVE server-side
                # (out-of-order keeps it); name it in the next Register so
                # its multi-MB bundle leaves the shared LRU budget NOW,
                # not a TTL later (orphans would evict healthy tenants).
                st.stale = st.session_id
                st.session_id = None
            st.sent = None  # the server's view is gone either way
            payload, pending = self._session_payload(args, meta_base, st,
                                                     demand_reason=head)
            blob = self._call_with_retry(self._call_session, payload)
        decision = pending.pop("decision")
        self._commit_session(st, **pending)
        # the round's ONE client-side session.sync verdict: the rung the
        # round ultimately shipped (a demand-answered round records the
        # resync rung with the server's demand class as the reason)
        decisions.record_decision("session.sync", *decision,
                                  registry=self._registry,
                                  tenant=self._tenant)
        return blob

    def _session_payload(self, args, meta_base: dict, st: _FamilyState,
                         demand_reason: str | None = None) -> tuple:
        """(wire payload, commit kwargs). Decides full vs delta: full on
        first contact with this shape family, a journal gap, or an opaque
        journal entry; delta otherwise — changed arrays only, row-spliced
        when less than half the leading axis moved. `args` shapes always
        match `st.sent` by construction (the family key IS every array's
        name/shape/dtype), so there is no shape-change case.
        `demand_reason` names the server demand a re-upload answers (the
        session.sync decision's reason, also shipped as `sync_reason`
        meta so the server's ledger half attributes the full upload)."""
        from karpenter_tpu_torch.service.session import ROWS_SUFFIX, VALS_SUFFIX

        if st.session_id is None:
            self._register_session(st)
        seq = st.seq + 1
        meta = dict(meta_base)
        meta.update(session=st.session_id, seq=seq,
                    tenant=self._tenant)
        journal = None
        generation = seq
        if self._cluster is not None:
            journal, generation = self._cluster.export_deltas(
                st.sent_generation)
        full_reason = None
        if st.sent is None:
            full_reason = ""  # initial upload: not a resync
        elif self._cluster is not None and journal is None:
            full_reason = "journal-gap"
        elif journal is not None and any(e is None for e in journal):
            full_reason = "opaque-delta"
        if full_reason is not None:
            if full_reason:
                self._count_resync(full_reason)
            sync_reason = demand_reason or full_reason or "initial"
            meta.update(mode="full", generation=generation,
                        sync_reason=sync_reason)
            codec = self._upload_codec()
            payload = _pack(args, meta, codec=codec)
            self._record_payload("full", len(payload), codec)
            stat = "full_uploads"
            decision = ("resync", sync_reason)
        else:
            patch: dict = {}
            wire: dict = {}
            for k, v in args.items():
                old = st.sent[k]
                if v.ndim >= 1 and v.shape[0] > 8:
                    # ONE elementwise pass serves both questions (changed
                    # at all? which rows?) — these are the multi-MB
                    # arrays, every reconcile round
                    moved = np.flatnonzero(
                        (old != v).reshape(v.shape[0], -1).any(axis=1))
                    if moved.size == 0:
                        continue
                    if moved.size <= v.shape[0] // 2:
                        patch[k] = "rows"
                        wire[k + ROWS_SUFFIX] = moved.astype(np.int64)
                        wire[k + VALS_SUFFIX] = v[moved]
                        continue
                elif np.array_equal(old, v):
                    continue
                patch[k] = "full"
                wire[k] = v
            meta.update(mode="delta", base_seq=st.seq,
                        patch=patch, journal=journal,
                        generation=generation)
            payload = _pack(wire, meta)  # deltas are small: no codec
            self._record_payload("delta", len(payload), None)
            stat = "delta_rounds"
            decision = ("delta", "ok")
        return payload, dict(args=args, seq=seq, generation=generation,
                             stat=stat, decision=decision)

    def _commit_session(self, st: _FamilyState, args, seq, generation, stat):
        st.sent = args
        st.seq = seq
        st.sent_generation = generation
        self.session_stats[stat] += 1


def main(argv=None) -> int:
    """`python -m karpenter_tpu_torch.service.solver_service [--port N]
    [--native] [--device cpu]` — run the device plane standalone (the gRPC
    analog of kwok/main.go for the solver half of the two-plane split),
    on the card unless ``--device cpu`` or ``--native``."""
    import argparse
    import signal
    import threading

    ap = argparse.ArgumentParser(prog="karpenter_tpu_torch.service.solver_service")
    ap.add_argument("--port", type=int, default=8400)
    ap.add_argument("--host", default="0.0.0.0",
                    help="bind address (containers need the pod IP "
                         "reachable; use 127.0.0.1 for local-only)")
    ap.add_argument("--native", action="store_true",
                    help="serve the C++ engine instead of the card")
    ap.add_argument("--device", default=None,
                    help="the solver's device: the card (cuda) by default, "
                         "raising without one; cpu for the plain path")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve /metrics + /healthz + /slo for this device "
                         "plane (0 = off); bind narrows via "
                         "KARPENTER_METRICS_BIND like the operator's")
    args = ap.parse_args(argv)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # non-main thread (tests)
    server, bound = serve(port=args.port, use_native=args.native,
                          host=args.host, device=args.device)
    metrics_server = None
    if args.metrics_port:
        from karpenter_tpu_torch.__main__ import serve_metrics
        from karpenter_tpu_torch.operator import metrics as _metrics

        metrics_server = serve_metrics(
            _metrics.REGISTRY, args.metrics_port,
            host=env_str("KARPENTER_METRICS_BIND", ""),
        )
        print(f"solver service: metrics on :{args.metrics_port} "
              f"(/metrics /healthz /slo /introspect)", flush=True)
    solver = server.solver_handler._solver
    print(f"solver service: listening on {args.host}:{bound} "
          f"({'native' if args.native else solver.device.type} engine)",
          flush=True)
    stop.wait()
    if metrics_server is not None:
        metrics_server.shutdown()
    server.stop(grace=2.0)
    from karpenter_tpu_torch.ops import cuda_kernels

    # the kernels this process launched over its life, for a caller that
    # reads the log (the launch counts live in this process only)
    print(f"solver service: stopped; kernel launches "
          f"{json.dumps(dict(cuda_kernels.LAUNCHES))}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
