"""Environment-knob readers (the copy of ``karpenter_tpu/utils/envknobs.py``
reduced to what the port reads: the float knobs of
``cloudprovider/types.py``, the LP rungs' knobs in ``ops/relax.py``,
``KARPENTER_WAVES_SEQUENTIAL`` in ``ops/waves.py``, the delta-journal cap
of ``state/cluster.py``, and the consolidation probe's knobs in
``ops/consolidate.py``: ``KARPENTER_REPLACE_MAX_CLAIMS``,
``KARPENTER_GLOBAL_REPAIR_MAX`` and ``KARPENTER_TIER_WEIGHT``; the engine
ladder's gates, each read once in ``ops/engines.py``:
``KARPENTER_NATIVE_CUTOFF``, ``KARPENTER_HOST_CUTOFF``,
``KARPENTER_DEVICE_MIN_WORK``, ``KARPENTER_ASSUME_ACCELERATOR`` and
``KARPENTER_RELAX``; ``KARPENTER_NATIVE_CACHE`` in
``native/``; the observability planes' knobs in ``obs/``:
``KARPENTER_TRACE``, ``KARPENTER_TRACE_DIR``, ``KARPENTER_TRACE_DUMP``,
``KARPENTER_TRACE_RING``, ``KARPENTER_COMPILE_STEADY_AFTER``,
``KARPENTER_DECISION_RING``, ``KARPENTER_RUNG_STEADY_AFTER``,
``KARPENTER_QUALITY_STEADY_AFTER``, ``KARPENTER_QUALITY_DRIFT_TOL``,
``KARPENTER_QUALITY_MIN_FLOOR``, ``KARPENTER_TIMELINE_RING``,
``KARPENTER_SAVINGS_DRIFT_TOL`` and ``KARPENTER_SAVINGS_STEADY_AFTER``;
the replay plane's ``KARPENTER_CAPSULE`` and ``KARPENTER_CAPSULE_BYTES``;
the solver service's knobs in ``service/``; the mesh's
``KARPENTER_SHARD_PARTITION`` and ``KARPENTER_SHARD_REPAIR_MAX`` in
``parallel/mesh.py``), plus ``snapshot``, the replay capsule's record of
every set ``KARPENTER_*`` knob, ``applied_env``, the save/apply/restore
half the capsule re-applies captured knobs through (and ``workload.
spot_storm`` sets its λ with), and ``inherited_env``, the environment a
child process starts with. This is the one module of the port that
touches ``os.environ`` (graftlint's GL501)."""

from __future__ import annotations

import os

__all__ = ["env_int", "env_float", "env_bool", "env_str", "snapshot",
           "applied_env", "inherited_env"]


def env_int(name: str, default: int, minimum: int | None = None) -> int:
    """Empty or unparseable falls back to `default`; `minimum` clamps the
    floor."""
    try:
        v = int(os.environ.get(name, "") or default)
    except ValueError:
        v = default
    return v if minimum is None else max(v, minimum)


def env_float(name: str, default: float,
              minimum: float | None = None) -> float:
    """Empty or unparseable falls back to `default`; `minimum` clamps the
    floor."""
    try:
        v = float(os.environ.get(name, "") or default)
    except ValueError:
        v = default
    return v if minimum is None else max(v, minimum)


def env_bool(name: str, default: bool) -> bool:
    """Unset/empty falls back to `default`; 0/false/off/no (any case)
    disable, anything else enables."""
    v = os.environ.get(name, "").strip().lower()
    if not v:
        return default
    return v not in ("0", "false", "off", "no")


def env_str(name: str, default: str | None = None) -> str | None:
    """Raw passthrough: the knob's exact string, or ``default`` when
    unset, for knobs whose call sites own the value test."""
    return os.environ.get(name, default)


class applied_env:
    """Temporarily apply ``mapping``'s values for ``names`` (a name absent
    from the mapping is UNSET, not left alone), restoring the previous
    environment on exit. The replay capsule (obs/capsule.py) rides this to
    reproduce capture-time routing/partition knobs around an offline
    replay; tests use it for knob pinning without os.environ surgery."""

    def __init__(self, mapping: dict, names):
        self._names = tuple(names)
        self._mapping = dict(mapping or {})
        self._saved: dict = {}

    def __enter__(self):
        for n in self._names:
            self._saved[n] = os.environ.get(n)
            if n in self._mapping:
                os.environ[n] = self._mapping[n]
            else:
                os.environ.pop(n, None)
        return self

    def __exit__(self, et, ev, tb):
        for n, v in self._saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
        return False


def inherited_env() -> dict:
    """A copy of the whole environment, for a child process to start
    with (``workload.solver_server``)."""
    return dict(os.environ)


def snapshot(prefix: str = "KARPENTER_") -> dict:
    """Every set env knob under ``prefix`` — the replay capsule's
    environment record (obs/capsule.py)."""
    return {k: v for k, v in os.environ.items() if k.startswith(prefix)}
