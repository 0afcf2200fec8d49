"""Consolidation-side snapshot helpers.

The port's copy of part of ``karpenter_tpu/ops/consolidate.py``: for now
only ``_group_type_compat``, the host group×type compat mask the LP bin
floor (``ops/relax.py``) prices groups over. The batched consolidation
probe, the disruption snapshot cache and the joint retirement search are
a later slice of the port (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import numpy as np


def _group_type_compat(snap, gsel=None):
    """[n,T] bool — template compat ∧ requirement overlap (with the
    Intersects tolerance rule) ∧ some offering admissible for the
    group's zone/capacity-type sets, availability included. The per-pod
    vs aggregate FIT check stays with each caller."""
    s = snap
    sel = slice(None) if gsel is None else gsel
    tmpl_ok = s.g_tmpl_ok[sel][:, s.t_tmpl]  # [n,T]
    shared = s.g_has[sel][:, None, :] & s.t_has[None, :, :]
    ov = ((s.g_mask[sel][:, None] & s.t_mask[None, :]) != 0).any(-1)
    both_tol = s.g_tol[sel][:, None, :] & s.t_tol[None, :, :]
    req_ok = (~shared | ov | both_tol).all(-1)  # [n,T]
    zo, co = s.off_zone, s.off_ct
    zok = np.where(
        zo[None, :, :] >= 0,
        s.g_zone_allowed[sel][:, np.maximum(zo, 0)], True)
    cok = np.where(
        co[None, :, :] >= 0,
        s.g_ct_allowed[sel][:, np.maximum(co, 0)], True)
    off_ok = (s.off_avail[None] & zok & cok).any(-1)  # [n,T]
    return tmpl_ok & req_ok & off_ok
