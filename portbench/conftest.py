"""Fixtures of the benchmark's tests shared by every folder below this one.

``portbench/tests/conftest.py`` cuts each cell of ``BENCHMARK.json`` to
the size of its ``SMALL`` table before a test runs it; the cells added
after that table are given their small sizes here, beside it: nodes per
input (the burst keeps its size; its tests cut it), inputs per ring and
instance types.
"""

from __future__ import annotations

from portbench.tests import conftest as tests_conftest

tests_conftest.SMALL.setdefault("live-5000", (24, 2, 64))
