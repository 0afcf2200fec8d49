"""The table of peaks and the least time of a compat launch.

Frozen copies of ``chip_smoke.py``'s H100 peaks (``:291-294``) and of its
``compat_bound_ms`` (``:447-465``), so that a later change to the program
cannot move the yardstick.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
3.35 TB/s of HBM, and 67 TFLOP/s of float32 outside the tensor cores,
against which the kernel's integer and logic operations are counted. Both
assume the card's full power limit of 700 W; the harness reports the
card's ``power.limit`` beside every share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12


def compat_bound_ms(G: int, T: int, K: int, W: int, pairs: int,
                    mask_itemsize: int = 4) -> tuple:
    """Least time of one compat launch of ``G`` group rows against ``T``
    type rows over ``K`` keys of ``W`` mask words, where ``pairs`` is the
    number of (group row, type row, key) triples that both rows define:
    each input byte read once and each output byte written once at HBM
    rate (masks, ``has`` rows, and the ``tol`` rows at one byte per key),
    against the 2W+3 logic operations of each defined pair at the vector
    rate; the larger of the two, and which one it is."""
    in_bytes = (G + T) * K * W * mask_itemsize + 2 * (G + T) * K
    bytes_ms = (in_bytes + G * T) / HBM_BYTES_PER_S * 1e3
    ops_ms = pairs * (2 * W + 3) / VECTOR_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def defined_pairs(g_has, t_has) -> int:
    """``pairs`` of ``compat_bound_ms`` from the launch's ``has`` rows
    (torch bool tensors [G,K] and [T,K]): Σ over keys of the group rows
    that define it times the type rows that define it."""
    import torch

    per_key = g_has.sum(0, dtype=torch.int64) * t_has.sum(0, dtype=torch.int64)
    return int(per_key.sum())
