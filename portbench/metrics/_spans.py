"""Shared arithmetic of the span readers: the median over the window's
unprofiled decisions of one program span's milliseconds per decision, and
the attributes of one span's instances, decision by decision."""

from __future__ import annotations

import statistics


def median_span(ctx, name: str):
    values = [d["spans"][name] for d in ctx.decisions
              if d.get("spans") and name in d["spans"]]
    return statistics.median(values) if values else None


def attrs(ctx, name: str) -> list:
    """For each of the window's unprofiled traced decisions, the
    attributes of every ``name`` span it opened."""
    return [[a for n, a in d["span_attrs"] if n == name]
            for d in ctx.decisions if d.get("span_attrs") is not None]
