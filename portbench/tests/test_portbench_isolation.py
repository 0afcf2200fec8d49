"""Isolation: no module the benchmark loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``karpenter_tpu``, and the plain reference
imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "karpenter_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_the_jax_package(path):
    names = set(_imports(path))
    assert not names & BANNED
    if "reference" in path.parts:
        assert "karpenter_tpu_torch" not in names


def test_a_run_loads_neither_jax_nor_the_jax_package(small_root):
    code = (
        "import json, sys\n"
        "from portbench import run\n"
        "from portbench.spec import Spec\n"
        f"spec = Spec({str(small_root)!r})\n"
        "out = run.run_cell(spec, spec.cell('diverse-500'), 5, 0.05, True, device='cpu')\n"
        "print(json.dumps([out['correct'], run.banned_modules(),\n"
        "                  sorted({m.split('.')[0] for m in sys.modules})]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    correct, banned, loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert correct and banned == [] and not set(loaded) & BANNED
    assert "karpenter_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_program(small_root):
    code = (
        "import json, sys\n"
        "from portbench.reference import control\n"
        "from portbench.spec import Spec\n"
        f"spec = Spec({str(small_root)!r})\n"
        "out = control.run(spec, spec.cell('burst-50k'), 5, 0.05, 'cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & (BANNED | {"karpenter_tpu_torch"})


@pytest.mark.parametrize("kind", sorted(p.stem for p in (ROOT / "portbench" / "kinds").glob("*.py")
                                        if p.stem != "__init__"))
def test_a_kind_but_its_program_side_loads_nothing_of_the_program(small_root, kind):
    """Every kind's module, its plain generator and its plain reference
    load nothing of the program; only its ``program`` does."""
    code = (
        "import json, sys\n"
        "from portbench import gen\n"
        "from portbench.spec import Spec\n"
        f"spec = Spec({str(small_root)!r})\n"
        f"cell = next(c for c in spec.cells.values() if spec.traffic(c).get('kind', 'provisioning') == {kind!r})\n"
        "cfg, traffic = spec.config(cell), spec.traffic(cell)\n"
        "k = spec.kind(traffic)\n"
        "plain_catalog = gen.catalog(cfg)\n"
        "ring = k.ring(cfg, plain_catalog, traffic, 5)\n"
        "cat = k.Catalog(cfg, plain_catalog)\n"
        "assert set(k.CHECKS) and k.placed(ring[0], {'claims': [], 'errors': [], 'retired': [], "
        "'replacements': [], 'placement': {}}) >= 0\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & (BANNED | {"karpenter_tpu_torch"})


def test_a_consolidation_run_loads_neither_jax_nor_the_jax_package(small_root):
    code = (
        "import json, sys\n"
        "from portbench import run\n"
        "from portbench.spec import Spec\n"
        f"spec = Spec({str(small_root)!r})\n"
        "out = run.run_cell(spec, spec.cell('consolidate-2000'), 5, 0.05, True, device='cpu')\n"
        "print(json.dumps([out['correct'], run.banned_modules(),\n"
        "                  sorted({m.split('.')[0] for m in sys.modules})]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    correct, banned, loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert correct and banned == [] and not set(loaded) & BANNED
    assert "karpenter_tpu_torch" in loaded
