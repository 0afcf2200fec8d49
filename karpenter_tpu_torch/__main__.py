"""Deployable operator entry point of the port: ``python -m karpenter_tpu_torch``.

The port's copy of ``karpenter_tpu/__main__.py`` (the kwok/main.go:33-48 +
operator.go:111-220 analog): wire the operator runtime — store, kwok cloud
provider, the full controller ring, disruption — and run it against
wall-clock time until SIGINT/SIGTERM or ``--max-ticks``.

    python -m karpenter_tpu_torch --manifest cluster.json [--tick 1.0]
        [--metrics] [--device cpu]

Manifests are JSON documents (a single object or a list) in EITHER
karpenter.sh API version — NodePool/NodeClaim wire docs run through the
conversion layer (``api/conversion.py``), the kwok catalog backs instance
types, and a ``Pod`` shorthand (``{"kind": "Pod", "name", "cpu", "memory",
"replicas"}``) seeds workload. ``--metrics`` serves the Prometheus
registry at ``/metrics``, liveness at ``/healthz`` and the observability
planes' JSON at ``/slo``, ``/introspect`` and ``/usage`` on
``KARPENTER_METRICS_PORT``.

The solver is ``make_solver()``: ``TorchSolver()`` on the CUDA card, with
the engine ladder of ``models/solver.py``; without a card it raises.
``--device cpu`` (the counterpart of the JAX package's
``JAX_PLATFORMS=cpu``) runs ``TorchSolver(device="cpu")``, whose batches
take the native engine (a CPU is not an accelerator) or the plain PyTorch
path. Not in the port yet (ROADMAP.md Queue 1 item 2): ``--solver`` /
``KARPENTER_SOLVER_TARGET`` (the solver service), which are refused.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading

from karpenter_tpu_torch.utils.envknobs import env_str

GIB = 2**30


def load_manifest(env, path: str) -> int:
    """Apply a JSON manifest file (v1 or v1beta1 docs) to the store."""
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod

    with open(path) as f:
        docs = json.load(f)
    if isinstance(docs, dict):
        docs = [docs]
    n = 0
    for doc in docs:
        kind = doc.get("kind", "")
        if kind == "NodePool":
            n += _apply(env, "nodepools", doc)
        elif kind == "NodeClaim":
            n += _apply(env, "nodeclaims", doc)
        elif kind == "Pod":
            replicas = int(doc.get("replicas", 1))
            for i in range(replicas):
                name = doc.get("name", "pod")
                env.store.create("pods", Pod(
                    metadata=ObjectMeta(
                        name=f"{name}-{i}" if replicas > 1 else name,
                        labels=dict(doc.get("labels", {})),
                    ),
                    requests={
                        "cpu": float(doc.get("cpu", 1.0)),
                        "memory": float(doc.get("memory", 1.0)) * GIB,
                    },
                ))
                n += 1
        else:
            raise SystemExit(f"unsupported manifest kind {kind!r}")
    return n


def _apply(env, plural: str, doc: dict) -> int:
    from karpenter_tpu_torch.api.conversion import ConversionError, decode

    try:
        env.store.create(plural, decode(doc))
    except ConversionError as e:
        raise SystemExit(
            f"manifest {doc.get('kind')}/{doc.get('metadata', {}).get('name')}: {e}"
        ) from e
    return 1


def serve_metrics(registry, port: int, host: str = ""):
    """Prometheus text endpoint (the operator.go:160 metrics mux analog)
    on a daemon thread, plus the health/SLO/introspection surfaces:
    ``/healthz`` liveness, ``/slo`` (the device-plane SLO trackers and
    the compile ledger, obs/devplane.py), ``/introspect`` (the decision
    plane's rung mixes, round summaries, quality series, retained
    anomalous rounds and the fleet timeline, obs/decisions.py; ``python
    -m karpenter_tpu_torch.obs report`` renders it) and ``/usage`` (the
    fleet ledger's per-tenant device-time billing, obs/timeline.py). The
    caller shuts the returned server down. ``host`` defaults to all
    interfaces for containerized scrapes; ``KARPENTER_METRICS_BIND``
    narrows it."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path not in ("/metrics", "/healthz", "/slo",
                                 "/introspect", "/usage"):
                self.send_response(404)
                self.end_headers()
                return
            if self.path == "/slo":
                from karpenter_tpu_torch.obs import devplane

                body = json.dumps(devplane.slo_snapshot()).encode()
                ctype = "application/json"
            elif self.path == "/introspect":
                from karpenter_tpu_torch.obs import decisions

                body = json.dumps(decisions.introspect_snapshot()).encode()
                ctype = "application/json"
            elif self.path == "/usage":
                from karpenter_tpu_torch.obs import timeline

                body = json.dumps(timeline.usage_snapshot()).encode()
                ctype = "application/json"
            else:
                body = (
                    registry.expose() if self.path == "/metrics" else "ok"
                ).encode()
                ctype = "text/plain; version=0.0.4"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    server = HTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="karpenter_tpu_torch")
    ap.add_argument("--manifest", action="append", default=[],
                    help="JSON manifest file(s) applied at startup")
    ap.add_argument("--tick", type=float, default=1.0,
                    help="reconcile tick seconds (controller poll cadence)")
    ap.add_argument("--metrics", action="store_true",
                    help="serve /metrics + /healthz on KARPENTER_METRICS_PORT")
    ap.add_argument("--max-ticks", type=int, default=0,
                    help="exit after N ticks (0 = run until signal)")
    ap.add_argument("--device", default="cuda",
                    help="the solver's device: cuda (the default; raises "
                         "without a card) or cpu (the plain path)")
    ap.add_argument("--solver", default=None,
                    help="a solver service address: not in the port yet, "
                         "refused")
    args = ap.parse_args(argv)
    if args.solver or env_str("KARPENTER_SOLVER_TARGET"):
        ap.error("--solver / KARPENTER_SOLVER_TARGET: the solver service is "
                 "not in the port yet; run without it")

    from karpenter_tpu_torch.models.solver import TorchSolver, make_solver
    from karpenter_tpu_torch.operator import Environment
    from karpenter_tpu_torch.operator.logging import make_logger
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.utils.clock import Clock

    options = Options.from_env()
    solver = (make_solver() if args.device == "cuda"
              else TorchSolver(device=args.device))
    env = Environment(
        clock=Clock(),  # wall-clock: budgets/TTLs run in real time
        sync=False,  # production batching window (1s idle / 10s max)
        enable_disruption=True,
        options=options,
        solver=solver,
        log=make_logger(options.log_level),
    )

    applied = sum(load_manifest(env, m) for m in args.manifest)
    print(f"karpenter-tpu-torch operator: {applied} manifest objects "
          f"applied, tick={args.tick}s, device={solver.device}",
          file=sys.stderr)

    server = (
        serve_metrics(env.registry, options.metrics_port,
                      host=options.metrics_bind_addr)
        if args.metrics else None
    )

    stop = threading.Event()
    prior = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            prior[sig] = signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # non-main thread (tests)

    ticks = 0
    try:
        while not stop.is_set():
            env.run_until_idle()
            ticks += 1
            if args.max_ticks and ticks >= args.max_ticks:
                break
            stop.wait(args.tick)
    finally:
        for sig, handler in prior.items():
            signal.signal(sig, handler)
        if server is not None:
            server.shutdown()
            server.server_close()
    nodes = len(env.store.list("nodes"))
    bound = sum(1 for p in env.store.list("pods") if p.node_name)
    print(f"karpenter-tpu-torch operator: stopped after {ticks} ticks "
          f"({nodes} nodes, {bound} bound pods)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
