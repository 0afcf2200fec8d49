"""Environment-knob readers (the copy of ``karpenter_tpu/utils/envknobs.py``
reduced to what the port reads: the two float knobs of
``cloudprovider/types.py``)."""

from __future__ import annotations

import os

__all__ = ["env_float"]


def env_float(name: str, default: float,
              minimum: float | None = None) -> float:
    """Empty or unparseable falls back to `default`; `minimum` clamps the
    floor."""
    try:
        v = float(os.environ.get(name, "") or default)
    except ValueError:
        v = default
    return v if minimum is None else max(v, minimum)
