"""Decision kinds: a kind added as files and entries alone runs through the
harness's own ``run_cell``, with no harness file edited."""

from __future__ import annotations

import json

from portbench import run
from portbench.spec import Spec
from portbench.tests.conftest import ROOT

SEED = 2**31 + 4127

# a kind in three files: its plain generator, its program side and its
# plain reference; the program side sorts numbers, the reference checks
# that each answer is its batch, sorted
GENERATOR = '''
from portbench import gen


def ring(traffic, seed):
    order = gen.rng_for(seed, 0x5EED).permutation(traffic["ring"]).tolist()
    return [gen.rng_for(i + 1).integers(0, 1000, traffic["numbers"]).tolist()
            for i in order]
'''
PROGRAM = '''
class Batch:
    def __init__(self, plain):
        self.plain = plain
        self.pods = plain

    def reset(self):
        pass


class Program:
    engine = "sorter"
    cuda = False

    def __init__(self, cfg, plain_catalog, traffic, device=None):
        pass

    batch = staticmethod(Batch)

    def decide(self, batch):
        return sorted(batch.plain), None

    @staticmethod
    def answer(results):
        return {"numbers": list(results)}

    @staticmethod
    def tally(results):
        return len(results), 0
'''
REFERENCE = '''
CHECKS = ("order",)


class Catalog:
    def __init__(self, cfg, plain_catalog):
        self.types = plain_catalog


def judge(cfg, cat, plain, answer):
    return {"order": int(answer["numbers"] != sorted(plain))}


def cost(cat, plain, answer):
    return float(len(cat.types))


def placed(plain, answer):
    return len(answer["numbers"])
'''
KIND = '''
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, HERE / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_ref = _load("sorting_reference")
CHECKS, Catalog, judge, cost, placed = (_ref.CHECKS, _ref.Catalog, _ref.judge,
                                        _ref.cost, _ref.placed)


def ring(cfg, plain_catalog, traffic, seed):
    return _load("sorting_gen").ring(traffic, seed)


def program(cfg, plain_catalog, traffic, device=None):
    return _load("sorting_program").Program(cfg, plain_catalog, traffic, device)
'''


def test_a_kind_added_by_files_alone(small_root):
    """A new decision kind (a generator, a program side and a reference),
    a mix that names it, a cell and a per-layer metric: new files under
    the benchmark's folders and new entries in BENCHMARK.json, and no
    other file changed; the cell runs through ``run_cell``, traced."""
    base = small_root.parent / "portbench"
    kinds = base / "kinds"
    for name, text in (("sorting", KIND), ("sorting_gen", GENERATOR),
                       ("sorting_program", PROGRAM),
                       ("sorting_reference", REFERENCE)):
        (kinds / f"{name}.py").write_text(text)
    (base / "traffic" / "sort-mix.json").write_text(json.dumps(
        {"kind": "sorting", "numbers": 64, "ring": 3, "sample": 4,
         "profile_decisions": 1}))
    (base / "metrics" / "numbers_seen.py").write_text(
        "def read(ctx):\n    return float(sum(d['pods'] for d in ctx.decisions))\n")
    doc = json.loads(small_root.read_text())
    doc["workloads"].append({"name": "sorted", "config": "upstream-400types",
                             "traffic": "sort-mix", "chips": 1, "why": "a test"})
    doc["per_layer"].append({"name": "numbers_seen", "unit": "numbers",
                             "better": "higher", "source": "program_counter",
                             "layer": "sorter", "moves": "decide_p50_ms",
                             "workloads": ["sorted"]})
    small_root.write_text(json.dumps(doc))
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*.py")}
    spec = Spec(small_root)
    out = run.run_cell(spec, spec.cell("sorted"), SEED, 0.05, True, device="cpu")
    assert out["correct"] is True, out["checks"]
    assert out["run"]["engines"] == ["sorter"]
    assert set(out["run"]["breaches"]) == {"order"}
    assert out["metrics"]["numbers_seen"]["value"] > 0
    assert out["run"]["decisions"] >= 3
    untraced = run.run_cell(spec, spec.cell("sorted"), SEED, 0.05, False, device="cpu")
    assert untraced["metrics"]["usd_per_kpod_h"]["value"] > 0
    assert {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*.py")} == before


def test_a_mix_without_a_kind_is_provisioning(small_root):
    spec = Spec(small_root)
    traffic = spec.traffic(spec.cell("burst-50k"))
    assert "kind" not in traffic
    kind = spec.kind(traffic)
    assert kind.CHECKS == __import__("portbench.reference.judge",
                                     fromlist=["CHECKS"]).CHECKS
    assert spec.kind(spec.traffic(spec.cell("consolidate-2000"))).CHECKS[0] == "retired"
