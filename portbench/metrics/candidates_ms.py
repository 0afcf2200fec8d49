"""``candidates_ms``: the median per decision of the program's
``disrupt.candidates`` span, the disruption controller's candidate
discovery over the fleet (controllers/disruption/controller.py
``_compute_round``, helpers.py ``get_candidates``). Nothing when no
decision opened it."""

from portbench.metrics._spans import median_span


def read(ctx):
    return median_span(ctx, "disrupt.candidates")
