"""graftlint core: project loading, findings, and suppressions.

The analyzer is a repo-native AST pass (stdlib only — it must import
neither torch nor the package it inspects, so the tier-1 gate stays cheap
and hermetic). Three moving parts live here:

- ``Module``: one parsed source file plus its ``# graftlint:`` directives
  (collected via tokenize, since ast drops comments),
- ``Project``: the module set a run analyzes, with enough import
  resolution for the cross-module rules (jit reachability, export drift,
  lock-order edges),
- ``Finding`` + suppression matching: a directive on the finding line, on
  the enclosing ``def``/``class`` header line, or a file-level
  ``disable-file`` mutes a finding; muted findings still count in the
  summary so drift stays visible.

Directive grammar (the ``--`` justification is REQUIRED — a bare
``disable=`` suppresses nothing, so every muted finding carries its why)::

    # graftlint: disable=GL101 -- host-side guard, jitted callers pass it
    # graftlint: disable=GL201,GL203 -- single-threaded test double
    # graftlint: disable-file=GL303 -- reconcile errors surface via events
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field

PACKAGE = "karpenter_tpu_torch"

# the `-- justification` clause is MANDATORY: a bare disable does not
# suppress anything, so the ROADMAP policy ("suppress only with an inline
# justification") is machine-enforced, not aspirational
_DIRECTIVE = re.compile(
    r"#\s*graftlint:\s*(disable|disable-file)\s*=\s*([A-Za-z0-9_,\s]+?)\s*--\s*\S"
)


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class Module:
    path: str
    name: str  # dotted module name, e.g. karpenter_tpu_torch.ops.kernels
    source: str
    tree: ast.Module = field(init=False)
    # line -> rule ids disabled on that line
    line_disables: dict = field(default_factory=dict)
    file_disables: set = field(default_factory=set)
    # (start, end, header_line) for every def/class scope
    scopes: list = field(default_factory=list)

    def __post_init__(self):
        self.tree = ast.parse(self.source, filename=self.path)
        self._collect_directives()
        self._collect_scopes()

    def _collect_directives(self):
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _DIRECTIVE.search(tok.string)
                if not m:
                    continue
                rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
                if m.group(1) == "disable-file":
                    self.file_disables |= rules
                else:
                    self.line_disables.setdefault(tok.start[0], set()).update(rules)
        except tokenize.TokenError:
            pass  # unterminated source: ast.parse would have raised first

    def _collect_scopes(self):
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                self.scopes.append((node.lineno, node.end_lineno, node.lineno))

    def suppressed(self, line: int, rule: str) -> bool:
        if rule in self.file_disables:
            return True
        if rule in self.line_disables.get(line, ()):
            return True
        # a directive on a comment-only line covers the statement below it
        lines = self.source.splitlines()
        prev = line - 1
        while prev >= 1 and prev <= len(lines) and lines[prev - 1].lstrip().startswith("#"):
            if rule in self.line_disables.get(prev, ()):
                return True
            prev -= 1
        for start, end, header in self.scopes:
            if start <= line <= end and rule in self.line_disables.get(header, ()):
                return True
        return False


def _module_name(path: str) -> str:
    """Dotted module name anchored at the package directory; files outside
    the package (fixtures, scripts) get their stem."""
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    if PACKAGE in parts:
        # LAST occurrence: a checkout directory named karpenter_tpu_torch (the
        # natural clone name) must not double the module prefix and break
        # cross-module import resolution
        rel = parts[len(parts) - 1 - parts[::-1].index(PACKAGE):]
    else:
        rel = [parts[-1]]
    if rel[-1].endswith(".py"):
        rel[-1] = rel[-1][:-3]
    if rel[-1] == "__init__":
        rel = rel[:-1]
    return ".".join(rel) or "__main__"


class Project:
    """The analyzed module set with minimal import resolution."""

    def __init__(self, modules: list):
        self.modules: dict = {m.name: m for m in modules}

    @classmethod
    def from_paths(cls, paths) -> "Project":
        files = []
        for p in paths:
            if os.path.isdir(p):
                for root, dirs, names in os.walk(p):
                    dirs[:] = sorted(d for d in dirs if not d.startswith((".", "__pycache__")))
                    files.extend(os.path.join(root, n) for n in sorted(names) if n.endswith(".py"))
            elif os.path.isfile(p) and p.endswith(".py"):
                files.append(p)
            else:
                # a vanished path must fail the gate loudly, not let it
                # pass vacuously with zero modules analyzed
                raise FileNotFoundError(f"graftlint: no such file or directory: {p!r}")
        modules = []
        for f in files:
            with open(f, encoding="utf-8") as fh:
                src = fh.read()
            modules.append(Module(path=f, name=_module_name(f), source=src))
        return cls(modules)

    @classmethod
    def from_sources(cls, sources: dict) -> "Project":
        """Test fixtures: {dotted_name: source}. Paths are synthesized; a
        name ending in ``.__init__`` becomes a package __init__.py module
        named without the suffix (so GL302's package rules apply)."""
        modules = []
        for name, src in sources.items():
            path = name.replace(".", "/") + ".py"
            if name.endswith(".__init__"):
                name = name[: -len(".__init__")]
            modules.append(Module(path=path, name=name, source=src))
        return cls(modules)

    # -- import resolution -------------------------------------------------
    def resolve_imports(self, module: Module) -> dict:
        """Local name -> ("module", Module) | ("symbol", Module, symbol).
        Covers the absolute-import idioms the package uses, including
        function-local imports."""
        env: dict = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    target = self.modules.get(alias.name)
                    if target is not None:
                        env[alias.asname or alias.name.split(".")[0]] = ("module", target)
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for alias in node.names:
                    sub = self.modules.get(f"{node.module}.{alias.name}")
                    if sub is not None:
                        env[alias.asname or alias.name] = ("module", sub)
                        continue
                    src = self.modules.get(node.module)
                    if src is not None:
                        env[alias.asname or alias.name] = ("symbol", src, alias.name)
        return env

    def top_level_functions(self, module: Module) -> dict:
        return {
            n.name: n
            for n in module.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }

    def classes(self):
        """Yield (module, ClassDef) over the whole project."""
        for mod in self.modules.values():
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef):
                    yield mod, node


def dotted(node) -> str:
    """Best-effort dotted-name rendering of a Name/Attribute chain."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return dotted(node.func)
    return ""
