"""The consolidation kind: one disruption decision over an underutilized
fleet.

Its plain generator is ``fleet.py``, its program side ``disrupt.py`` (the
only part that imports the program) and its plain reference
``reference/consolidation.py``; ``kinds/provisioning.py`` says what a
kind supplies.
"""

from __future__ import annotations

from portbench import fleet
from portbench.reference import consolidation as ref

CHECKS = ref.CHECKS
Catalog = ref.Catalog
judge = ref.judge
cost = ref.cost
placed = ref.placed


def ring(cfg: dict, plain_catalog: list, traffic: dict, seed: int) -> list:
    """The ring of plain fleets a run cycles (``fleet.ring``)."""
    return fleet.ring(cfg, plain_catalog, traffic, seed)


def program(cfg: dict, plain_catalog: list, traffic: dict, device=None):
    """``disrupt.Program`` for the configuration, on ``device``."""
    from portbench import disrupt

    return disrupt.Program(cfg, plain_catalog, traffic, device)
