"""obs: the reconcile flight recorder (span tracing + anomaly dumps).

The port's copy of ``karpenter_tpu/obs`` (imports changed):

- ``round_trace(name, registry=...)`` opens one traced reconcile round;
  ``span(name, kind=...)`` nests timed regions under it (``kind`` in
  {host, device, cache}); ``anomaly(kind, ...)`` marks the round so the
  flight recorder dumps its Chrome trace-event JSON. See
  :mod:`karpenter_tpu_torch.obs.trace` for the model and env knobs, and
  :mod:`karpenter_tpu_torch.obs.recorder` for the dump format.
- :mod:`karpenter_tpu_torch.obs.devplane`: the compile ledger (cold and
  warm dispatches per family and key, the
  ``cold-compile-in-steady-state`` anomaly), pow-2 padding-waste
  accounting, and the SLO trackers behind the ``/slo`` endpoint.
- :mod:`karpenter_tpu_torch.obs.decisions`: one ``(site, rung, reason)``
  verdict per ladder invocation, the ``rung-regression`` and
  ``solve-overhead-drift`` anomalies, the ``/introspect`` surface and
  ``python -m karpenter_tpu_torch.obs report``.
- :mod:`karpenter_tpu_torch.obs.timeline`: the fleet ledger — the node
  lifecycle timeline with cause chains, realized cost and per-command
  savings reconciliation, per-tenant device-time billing (``/usage``)
  and the observed interruption rates.
- :mod:`karpenter_tpu_torch.obs.capsule`: the replay plane — every
  hot-path dispatch seam captures the dispatch's exact numpy inputs and
  host outputs by reference; anomalous rounds serialize ONE
  ``.capsule.npz`` next to their Chrome dump, in the JAX package's file
  format, and ``python -m karpenter_tpu_torch.obs replay <capsule>
  [--ab]`` re-executes it (and A/Bs every eligible rung).

Every hook is host-side: none runs inside the pack loop
(``ops/kernels.py``) or ``ops/cuda_kernels.py``.
"""

from karpenter_tpu_torch.obs import capsule, decisions, devplane, timeline
from karpenter_tpu_torch.obs.recorder import FlightRecorder, chrome_events
from karpenter_tpu_torch.obs.trace import (
    RECORDER,
    TRACER,
    Span,
    Trace,
    Tracer,
    anomaly,
    attach,
    configure,
    current_trace_id,
    discard_round,
    reset,
    round_trace,
    span,
)

__all__ = [
    "FlightRecorder",
    "capsule",
    "chrome_events",
    "decisions",
    "devplane",
    "timeline",
    "RECORDER",
    "TRACER",
    "Span",
    "Trace",
    "Tracer",
    "anomaly",
    "attach",
    "configure",
    "current_trace_id",
    "discard_round",
    "reset",
    "round_trace",
    "span",
]
