"""The live kind: one provisioning decision onto a running cluster.

Its plain generator is ``live.py`` (a fleet of ``fleet.py`` and a burst of
``gen.py``'s mix), its program side ``live_system.py`` (the only part
that imports the program) and its plain reference ``reference/live.py``;
``kinds/provisioning.py`` says what a kind supplies.
"""

from __future__ import annotations

from portbench import live
from portbench.reference import live as ref

CHECKS = ref.CHECKS
Catalog = ref.Catalog
judge = ref.judge
cost = ref.cost
placed = ref.placed


def ring(cfg: dict, plain_catalog: list, traffic: dict, seed: int) -> list:
    """The ring of plain inputs a run cycles (``live.ring``)."""
    return live.ring(cfg, plain_catalog, traffic, seed)


def program(cfg: dict, plain_catalog: list, traffic: dict, device=None):
    """``live_system.Program`` for the configuration, on ``device``."""
    from portbench import live_system

    return live_system.Program(cfg, plain_catalog, traffic, device)
