"""Shared arithmetic of the span readers: the median over the window's
unprofiled decisions of one program span's milliseconds per decision."""

from __future__ import annotations

import statistics


def median_span(ctx, name: str):
    values = [d["spans"][name] for d in ctx.decisions
              if d.get("spans") and name in d["spans"]]
    return statistics.median(values) if values else None
