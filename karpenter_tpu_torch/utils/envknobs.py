"""Environment-knob readers (the copy of ``karpenter_tpu/utils/envknobs.py``
reduced to what the port reads: the float knobs of
``cloudprovider/types.py``, the LP rungs' knobs in ``ops/relax.py``,
``KARPENTER_WAVES_SEQUENTIAL`` in ``ops/waves.py``, the delta-journal cap
of ``state/cluster.py``, and the consolidation probe's knobs in
``ops/consolidate.py``: ``KARPENTER_REPLACE_MAX_CLAIMS``,
``KARPENTER_GLOBAL_REPAIR_MAX``, ``KARPENTER_TIER_WEIGHT`` and
``KARPENTER_GLOBAL_FORMULATE_LOOP``)."""

from __future__ import annotations

import os

__all__ = ["env_int", "env_float", "env_bool", "env_str"]


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
