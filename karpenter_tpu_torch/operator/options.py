"""Operator options: flags + env fallback + feature gates.

Mirror of the reference's pkg/operator/options (options.go:83-98): every
knob has a default, an env-var fallback (KARPENTER_ prefixed, like
BoolVarWithEnv options.go:70), and a constructor override; feature gates
parse the k8s component-base "Name=bool,Name=bool" string
(options.go:128-133 — the single reference gate is SpotToSpotConsolidation,
consumed by consolidation.go:214).

The port's copy of ``karpenter_tpu/operator/options.py`` (imports changed).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from karpenter_tpu_torch.utils.envknobs import env_str


def _env(name: str, default, cast=str):
    raw = env_str(f"KARPENTER_{name}")
    if raw is None:
        return default
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes")
    return cast(raw)


def parse_feature_gates(spec: str) -> dict:
    """"SpotToSpotConsolidation=true,Foo=false" → {snake_case: bool}."""
    gates = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"invalid feature gate {part!r} (want Name=bool)")
        name, val = part.split("=", 1)
        key = _snake(name.strip())
        v = val.strip().lower()
        if v not in ("true", "false"):
            raise ValueError(f"invalid feature gate value {part!r}")
        gates[key] = v == "true"
    return gates


def _snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0 and (not name[i - 1].isupper()):
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


@dataclass
class Options:
    # batching window (options.go:96-97)
    batch_idle_duration: float = 1.0
    batch_max_duration: float = 10.0
    # apiserver client limits (options.go:90-91)
    kube_client_qps: float = 200.0
    kube_client_burst: int = 300
    # service ports
    metrics_port: int = 8000
    # metrics bind address: "" = all interfaces (a container's Prometheus
    # scrape arrives on the pod IP); set KARPENTER_METRICS_BIND=127.0.0.1
    # for local-only exposure — the mirror of the solver service's --host
    metrics_bind_addr: str = ""
    health_probe_port: int = 8081
    # observability
    log_level: str = "info"
    enable_profiling: bool = False
    # feature gates (snake_case keys; options.go:128-133)
    feature_gates: dict = field(default_factory=lambda: {"spot_to_spot_consolidation": False})

    @classmethod
    def from_env(cls, **overrides) -> "Options":
        opts = cls(
            batch_idle_duration=_env("BATCH_IDLE_DURATION", 1.0, float),
            batch_max_duration=_env("BATCH_MAX_DURATION", 10.0, float),
            kube_client_qps=_env("KUBE_CLIENT_QPS", 200.0, float),
            kube_client_burst=_env("KUBE_CLIENT_BURST", 300, int),
            metrics_port=_env("METRICS_PORT", 8000, int),
            metrics_bind_addr=_env("METRICS_BIND", ""),
            health_probe_port=_env("HEALTH_PROBE_PORT", 8081, int),
            log_level=_env("LOG_LEVEL", "info"),
            enable_profiling=_env("ENABLE_PROFILING", False, bool),
        )
        gates = _env("FEATURE_GATES", "")
        if gates:
            opts.feature_gates.update(parse_feature_gates(gates))
        for k, v in overrides.items():
            if k == "feature_gates":
                opts.feature_gates.update(v)
            elif not hasattr(opts, k):
                raise TypeError(f"unknown option {k!r}")
            else:
                setattr(opts, k, v)
        return opts

    def gate(self, name: str) -> bool:
        return bool(self.feature_gates.get(name, False))
