"""``BENCHMARK.json`` and the files it names.

The harness is driven by data: a cell names a configuration (its file is
the ``file`` of that entry of ``configs``), a traffic mix (the file
``portbench/traffic/<traffic>.json``) and, through the metrics that list
it, the readers ``portbench/metrics/<name>.py``, all beside the
``BENCHMARK.json`` read. The mix names its decision kind under ``kind``
(``provisioning`` where it names none): the file
``portbench/kinds/<kind>.py``, which supplies the kind's plain generator,
its program side and its plain reference (``kinds/provisioning.py`` says
how). Adding a cell, a configuration, a mix, a per-layer metric or a
decision kind adds files and entries; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Spec:
    def __init__(self, path: Path | None = None):
        path = Path(path) if path is not None else ROOT / "BENCHMARK.json"
        self.path = path
        self.root = path.parent
        self.base = self.root / HERE.name
        self.doc = json.loads(path.read_text())
        self.configs = {c["name"]: c for c in self.doc["configs"]}
        self.cells = {w["name"]: w for w in self.doc["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise SystemExit(f"portbench: no workload {name!r} in {self.path}")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        entry = self.configs[cell["config"]]
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads(
            (self.base / "traffic" / f"{cell['traffic']}.json").read_text())

    def metrics(self, cell: dict, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports:
        those that list it, and those that list no cells and move (or are)
        a metric the cell reports."""
        e2e = [m for m in self.doc["end_to_end"] if _in(m, cell)]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.doc["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def reader(self, name: str):
        """The ``read(ctx)`` function of ``portbench/metrics/<name>.py``."""
        return _load(self.base / "metrics" / f"{name}.py",
                     f"portbench.metrics.{name}").read

    def kind(self, traffic: dict):
        """The module ``portbench/kinds/<kind>.py`` of the mix's decision
        kind."""
        name = traffic.get("kind", "provisioning")
        return _load(self.base / "kinds" / f"{name}.py", f"portbench.kinds.{name}")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _in(metric: dict, cell: dict) -> bool:
    return "workloads" not in metric or cell["name"] in metric["workloads"]
