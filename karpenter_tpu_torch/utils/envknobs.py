"""Environment-knob readers (the copy of ``karpenter_tpu/utils/envknobs.py``
reduced to what the port reads: the float knobs of
``cloudprovider/types.py``, the LP floor's knobs in ``ops/relax.py`` and
``KARPENTER_WAVES_SEQUENTIAL`` in ``ops/waves.py``)."""

from __future__ import annotations

import os

__all__ = ["env_int", "env_float", "env_str"]


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


def env_str(name: str, default: str | None = None) -> str | None:
    """Raw passthrough: the knob's exact string, or ``default`` when
    unset, for knobs whose call sites own the value test."""
    return os.environ.get(name, default)
