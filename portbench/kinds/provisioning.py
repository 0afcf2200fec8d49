"""The provisioning kind: ``TorchSolver.solve`` on a batch of pending pods.

A decision kind is a file ``portbench/kinds/<kind>.py`` that a traffic
file names under ``kind`` (this one where it names none). It supplies the
plain generator of its ring (``ring``), the program side (``program``,
the only part that imports the program), and the plain reference that
judges the program's answers (``CHECKS``, ``Catalog``, ``judge``,
``cost``, ``placed``). Here they are ``gen.py``, ``system.py`` and
``reference/judge.py``, wrapped.
"""

from __future__ import annotations

from portbench import gen
from portbench.reference import judge as ref

CHECKS = ref.CHECKS
Catalog = ref.Catalog
judge = ref.judge


def ring(cfg: dict, plain_catalog: list, traffic: dict, seed: int) -> list:
    """The ring of plain batches a run cycles (``gen.ring``)."""
    return gen.ring(traffic, seed)


def program(cfg: dict, plain_catalog: list, traffic: dict, device=None):
    """``system.Program`` for the configuration, on ``device``."""
    from portbench import system

    return system.Program(cfg, plain_catalog, traffic["topology"], device)


def cost(cat, plain: list, answer: dict) -> float:
    """The answer's hourly price (``judge.cost``)."""
    return ref.cost(cat, answer)


def placed(plain: list, answer: dict) -> int:
    """The pods the answer places (``judge.placed``)."""
    return ref.placed(answer)
