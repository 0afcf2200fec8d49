"""The port's static analysis (``karpenter_tpu_torch/analysis``) against the
JAX package's graftlint, and the port's tier-1 gate.

- The gate: the port's analyzer over ``karpenter_tpu_torch/`` finds
  nothing unsuppressed (every suppression carries a ``-- why``), through
  ``analyze_paths`` and through ``python -m karpenter_tpu_torch.analysis``
  (exit codes 0/1/2), and its GL502 census covers every decision site.
- Parity: every GL2xx, GL3xx and GL50x fixture of
  ``tests/test_static_analysis.py`` — the sources each of its test
  methods hands ``analyze_sources``, recorded while the JAX test runs —
  goes through both analyzers, the port's with the package name
  rewritten; both must report the same rule ids on the same lines, and
  suppress the same. One parametrised case per JAX test method.
- The PyTorch rules: positive and negative fixtures for GL101 (host reads
  of a tensor reachable from a device entry) and GL401–GL406 (a plane's
  call reachable from one), GL104 (``torch.compile`` in a loop), and the
  real pack loop with a read or a span spliced in.

Tolerance: exact (rule ids and lines).
"""

from __future__ import annotations

import inspect
import re
import subprocess
import sys
from pathlib import Path

import pytest

import tests.test_static_analysis as jtests
from karpenter_tpu.analysis import analyze_sources as jax_analyze
from karpenter_tpu_torch.analysis import (
    RULES,
    Project,
    analyze_paths,
    analyze_sources,
    producer_census,
)
from karpenter_tpu_torch.analysis.__main__ import main as cli_main

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "karpenter_tpu_torch"


def found(findings) -> list:
    return sorted((f.path, f.line, f.rule) for f in findings)


def rules_of(findings) -> list:
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


class TestGate:
    def test_port_has_zero_unsuppressed_findings(self):
        findings, suppressed = analyze_paths([str(PKG)])
        assert findings == [], "\n".join(f.render() for f in findings)
        # each suppression is deliberate, justified inline and listed in
        # CHANGES.md: the count is pinned so a new one is a diff
        assert len(suppressed) == 4
        assert {f.rule for f in suppressed} == {"GL101"}

    def test_every_module_is_analyzed(self):
        """Module names anchor at the package: no two files of the port
        collapse into one name (a stem-named module would hide another)."""
        project = Project.from_paths([str(PKG)])
        files = list(PKG.rglob("*.py"))
        assert len(project.modules) == len(files)
        assert all(n.startswith("karpenter_tpu_torch")
                   for n in project.modules)

    def test_cli_exit_codes(self, tmp_path, capsys):
        assert cli_main([str(PKG)]) == 0
        clean = tmp_path / "clean.py"
        clean.write_text("def ok():\n    return 1\n")
        assert cli_main([str(clean)]) == 0
        dirty = tmp_path / "dirty.py"
        dirty.write_text("import os\nX = os.environ.get('KARPENTER_X')\n")
        assert cli_main([str(dirty)]) == 1
        assert "dirty.py:2: GL501" in capsys.readouterr().out
        assert cli_main([str(tmp_path / "missing")]) == 2
        assert cli_main(["--rules", "GL999", str(clean)]) == 2
        # a baseline subtracts accepted findings
        base = tmp_path / "baseline.txt"
        assert cli_main(["--baseline", str(base), "--update-baseline",
                         str(dirty)]) == 0
        assert cli_main(["--baseline", str(base), str(dirty)]) == 0

    def test_module_entry_point_defaults_to_the_port(self):
        r = subprocess.run([sys.executable, "-m",
                            "karpenter_tpu_torch.analysis"],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "0 finding(s)" in r.stderr

    def test_rules_are_the_jax_packages_ids(self):
        from karpenter_tpu.analysis import RULES as JRULES

        assert set(RULES) == set(JRULES)
        assert RULES["GL102"].startswith("reserved")
        assert RULES["GL103"].startswith("reserved")

    def test_census_covers_every_decision_site(self):
        from karpenter_tpu_torch.obs.decisions import SITES

        census = producer_census(Project.from_paths([str(PKG)]))
        assert census["site_count"] == len(SITES)
        assert census["producers"] >= census["site_count"]
        assert set(census["sites_covered"]) == set(SITES)


# ---------------------------------------------------------------------------
# parity on the JAX package's GL2xx / GL3xx / GL50x fixtures
# ---------------------------------------------------------------------------

PARITY_CLASSES = ("TestLockRules", "TestDriftRules", "TestEnvKnobDiscipline",
                  "TestLedgerRules", "TestSeamRules", "TestDispatchLoopRules")
PARITY_CASES = [
    f"{cls}::{name}"
    for cls in PARITY_CLASSES
    for name, _ in inspect.getmembers(getattr(jtests, cls),
                                      inspect.isfunction)
    if name.startswith("test_")
]
_PKG_WORD = re.compile(r"\bkarpenter_tpu\b")


def to_port(sources: dict) -> dict:
    """A JAX fixture with the package name rewritten: module names and
    every source mention of ``karpenter_tpu``."""
    return {_PKG_WORD.sub("karpenter_tpu_torch", name):
            _PKG_WORD.sub("karpenter_tpu_torch", src)
            for name, src in sources.items()}


@pytest.mark.parametrize("case", PARITY_CASES)
def test_fixture_parity_with_jax(case, monkeypatch, request):
    cls_name, meth_name = case.split("::")
    seen = []

    def spy(sources, rules=None):
        seen.append((dict(sources), rules))
        return jax_analyze(sources, rules=rules)

    monkeypatch.setattr(jtests, "analyze_sources", spy)
    meth = getattr(getattr(jtests, cls_name)(), meth_name)
    params = inspect.signature(meth).parameters
    meth(**{p: request.getfixturevalue(p) for p in params})
    assert seen, f"{case} analyzed no fixture"
    for sources, rules in seen:
        jf, js = jax_analyze(sources, rules=rules)
        pf, ps = analyze_sources(to_port(sources), rules=rules)
        want = [(_PKG_WORD.sub("karpenter_tpu_torch", p), ln, r)
                for p, ln, r in found(jf)]
        wsup = [(_PKG_WORD.sub("karpenter_tpu_torch", p), ln, r)
                for p, ln, r in found(js)]
        assert found(pf) == sorted(want), sources.keys()
        assert found(ps) == sorted(wsup), sources.keys()


def test_parity_covers_every_shared_rule():
    """The recorded fixtures exercise every GL2xx/GL3xx/GL50x id."""
    ids = {r for r in RULES if r[:3] in ("GL2", "GL3", "GL5")}
    assert ids == {"GL201", "GL202", "GL203", "GL301", "GL302", "GL303",
                   "GL501", "GL502", "GL503", "GL504"}
    assert len(PARITY_CASES) >= 40


# ---------------------------------------------------------------------------
# the PyTorch GL101 / GL104 / GL40x rules
# ---------------------------------------------------------------------------

KERNELS = "karpenter_tpu_torch.ops.kernels"


def lint(src: str, name: str = KERNELS, extra: dict | None = None):
    return analyze_sources({name: src, **(extra or {})})


class TestHostReads:
    @pytest.mark.parametrize("read", [
        "x.item()", "x.cpu()", "x.numpy()", "x.tolist()", "float(x)",
        "int(x.sum())", "bool(x > 0)", "np.asarray(x)"])
    def test_positive_read_in_entry(self, read):
        findings, _ = lint(
            "import numpy as np\n"
            "def solve_step(args, max_bins):\n"
            "    x = args['g_count']\n"
            f"    y = {read}\n"
            "    return y\n")
        assert [(f.line, f.rule) for f in findings] == [(4, "GL101")]

    def test_positive_branch_on_a_tensor(self):
        findings, _ = lint(
            "def probe_step(varying, shared, max_bins, max_minv):\n"
            "    x = shared['g_count']\n"
            "    if x.any():\n"
            "        return 1\n"
            "    while x.sum() > 0:\n"
            "        x = x - 1\n"
            "    return 0 if x.all() else 1\n")
        assert [(f.line, f.rule) for f in findings] == [
            (3, "GL101"), (5, "GL101"), (7, "GL101")]

    def test_positive_read_reached_through_call_edges(self):
        findings, _ = lint(
            "from karpenter_tpu_torch.ops import helpers\n"
            "def _pack(args, F, tmpl_full, g_count, e_avail, **kw):\n"
            "    return helpers.step(F)\n",
            extra={"karpenter_tpu_torch.ops.helpers": (
                "def step(F):\n"
                "    return _inner(F.sum(1))\n"
                "def _inner(v):\n"
                "    return v.max().item()\n")})
        assert [(f.path, f.line, f.rule) for f in findings] == [
            ("karpenter_tpu_torch/ops/helpers.py", 4, "GL101")]

    def test_negative_static_params_shapes_and_host_code(self):
        findings, _ = lint(
            "def solve_step(args, max_bins, level_bits=20, max_minv=None,\n"
            "               with_existing=None, fma_rem=True):\n"
            "    x = args['g_count']\n"
            "    n = int(max_bins) + int(x.shape[0]) + x.numel()\n"
            "    if x.is_cuda and x.dim() == 1 and max_minv is None:\n"
            "        n += int(x.size(0))\n"
            "    if 'e_avail' in args and fma_rem:\n"
            "        n += 1\n"
            "    return x * n\n"
            "def host_only(x):\n"
            "    return x.item()\n")
        assert findings == []

    def test_negative_reads_outside_the_entry_table(self):
        findings, _ = lint(
            "def lp_bin_floor(lb_t):\n"
            "    return float(lb_t)\n",
            name="karpenter_tpu_torch.ops.relax")
        assert findings == []

    def test_suppression_with_justification(self):
        findings, suppressed = lint(
            "def solve_step(args, max_bins):\n"
            "    mv = args['m_minv']\n"
            "    # graftlint: disable=GL101 -- read before the first launch\n"
            "    return int(mv.max())\n")
        assert findings == [] and rules_of(suppressed) == ["GL101"]

    def test_compile_in_a_loop(self):
        findings, _ = lint(
            "import torch\n"
            "def build(fns):\n"
            "    out = []\n"
            "    for f in fns:\n"
            "        out.append(torch.compile(f))\n"
            "    return out, torch.compile(fns[0])\n",
            name="fx")
        assert [(f.line, f.rule) for f in findings] == [(5, "GL104")]


class TestPlanesOffTheQueue:
    @pytest.mark.parametrize("call,rule", [
        ("obs.span('pack.step')", "GL401"),
        ("TRACER.round_trace('r')", "GL401"),
        ("obs.anomaly('x')", "GL402"),
        ("RECORDER.dump()", "GL402"),
        ("devplane.record_dispatch('k', (1,), 0.1)", "GL403"),
        ("LEDGER.observe(1.0)", "GL403"),
        ("decisions.record_decision('mesh.partition', 'partitioned')",
         "GL404"),
        ("DECISIONS.record('solver.route', 'device')", "GL404"),
        ("capsule.record_capture('mesh.solve', {}, {})", "GL405"),
        ("capsule.capture()", "GL405"),
        ("timeline.record_event('launch')", "GL406"),
        ("TIMELINE.note('x')", "GL406"),
    ])
    def test_positive_plane_call_in_entry(self, call, rule):
        findings, _ = lint(
            "from karpenter_tpu_torch import obs\n"
            "def compat(g_mask, g_has, g_tol, t_mask, t_has, t_tol):\n"
            f"    {call}\n"
            "    return g_mask\n",
            name="karpenter_tpu_torch.ops.cuda_kernels")
        assert [(f.line, f.rule) for f in findings] == [(3, rule)]

    def test_positive_plane_call_reached_through_call_edge(self):
        findings, _ = lint(
            "from karpenter_tpu_torch.obs import devplane\n"
            "def floor_lb(d, n, alloc, compat, max_iters, tol, rho):\n"
            "    return _step(d)\n"
            "def _step(d):\n"
            "    devplane.record_padding('x', 1, 2)\n"
            "    return d\n",
            name="karpenter_tpu_torch.ops.relax")
        assert [(f.line, f.rule) for f in findings] == [(5, "GL403")]

    def test_negative_plane_calls_at_the_dispatch_site(self):
        findings, _ = lint(
            "from karpenter_tpu_torch import obs\n"
            "from karpenter_tpu_torch.ops import kernels\n"
            "def invoke(args):\n"
            "    with obs.span('solve.dispatch'):\n"
            "        out = kernels.solve_step(args, 64)\n"
            "    obs.devplane.record_dispatch('solve.kernel', (64,), 0.1)\n"
            "    return out['used'].cpu().numpy()\n",
            name="karpenter_tpu_torch.models.solver",
            extra={KERNELS: "def solve_step(args, max_bins):\n"
                            "    return args\n"})
        assert findings == []

    def test_negative_generic_verbs_on_other_receivers(self):
        findings, _ = lint(
            "def _pack(args, F, tmpl_full, g_count, e_avail, **kw):\n"
            "    store = {}\n"
            "    rows.record(F)\n"
            "    cache.observe(F)\n"
            "    return F\n")
        assert findings == []


class TestRealPackLoop:
    """The real ``ops/kernels.py`` is clean; a read or a span spliced into
    its pack loop is found."""

    def _sources(self, kernels_src: str) -> dict:
        ops = PKG / "ops"
        return {
            KERNELS: kernels_src,
            "karpenter_tpu_torch.ops.cuda_kernels":
                (ops / "cuda_kernels.py").read_text(),
            "karpenter_tpu_torch.ops.tensorize":
                (ops / "tensorize.py").read_text(),
        }

    def _splice(self, line: str) -> str:
        src = (PKG / "ops" / "kernels.py").read_text()
        anchor = "        if fma_cap:\n"
        assert src.count(anchor) == 1
        return src.replace(anchor, line + anchor)

    def test_real_kernels_clean(self):
        src = (PKG / "ops" / "kernels.py").read_text()
        findings, suppressed = analyze_sources(self._sources(src))
        assert findings == []
        assert rules_of(suppressed) == ["GL101"]

    def test_spliced_read_is_found(self):
        src = self._splice("        _ = load.sum().item()\n")
        findings, _ = analyze_sources(self._sources(src))
        line = src.splitlines().index("        _ = load.sum().item()") + 1
        assert [(f.line, f.rule) for f in findings] == [(line, "GL101")]

    def test_spliced_span_is_found(self):
        src = self._splice("        obs.span('pack.row')\n")
        findings, _ = analyze_sources(self._sources(src))
        line = src.splitlines().index("        obs.span('pack.row')") + 1
        assert [(f.line, f.rule) for f in findings] == [(line, "GL401")]
