"""GL3xx — drift checks: export surface and swallowed controller errors.

- GL301 stale-export: a name listed in a module's ``__all__`` that the
  module neither defines nor imports — a rename or deletion that left the
  public surface pointing at nothing (``from pkg import *`` and
  introspection-driven tools break at a distance).
- GL302 dead-export: an ``__init__.py`` re-export (``from .mod import X``)
  that is not in ``__all__`` and that nothing in the analyzed tree imports
  through the package path — surface that silently stopped being API.
  Listing a name in ``__all__`` documents intent and exempts it.
- GL303 swallowed-exception: in ``controllers/``, an ``except Exception``
  (or bare ``except``) whose handler neither re-raises, logs, counts, nor
  records the error — a reconcile loop that eats its failures is invisible
  exactly when it matters (the round-5 chaos flakes were this class).
"""

from __future__ import annotations

import ast

from karpenter_tpu_torch.analysis.core import Finding, dotted

RULES = {
    "GL301": "__all__ lists a name the module neither defines nor imports",
    "GL302": "__init__.py re-export not in __all__ and never imported via the package",
    "GL303": "except Exception in a controller path neither re-raises, logs, nor counts",
}

_LOGGISH = {
    "debug", "info", "warn", "warning", "error", "exception", "critical",
    "log", "inc", "observe", "record", "emit", "publish",
}


def _module_names(mod) -> tuple:
    """(defined, imported, all_entries_with_line)."""
    defined: set = set()
    imported: set = set()
    all_entries: list = []
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    defined.add(t.id)
                    if t.id == "__all__" and isinstance(node.value, (ast.List, ast.Tuple)):
                        for elt in node.value.elts:
                            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                                all_entries.append((elt.value, elt.lineno))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            defined.add(node.target.id)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                imported.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name == "*":
                    continue
                imported.add(alias.asname or alias.name)
    return defined, imported, all_entries


def _package_imports(project) -> set:
    """(package_name, symbol) pairs consumed anywhere in the tree via
    ``from package import symbol`` or ``package.symbol`` attribute access
    on an imported package alias."""
    used: set = set()
    for mod in project.modules.values():
        aliases: dict = {}  # local alias -> dotted module path
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for alias in node.names:
                    used.add((node.module, alias.name))
                    aliases[alias.asname or alias.name] = f"{node.module}.{alias.name}"
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    aliases[alias.asname or alias.name.split(".")[0]] = alias.name
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
                target = aliases.get(node.value.id)
                if target:
                    used.add((target, node.attr))
    return used


def check_exports(project) -> list:
    findings: list = []
    used = _package_imports(project)
    for mod in project.modules.values():
        defined, imported, all_entries = _module_names(mod)
        for name, line in all_entries:
            if name not in defined and name not in imported:
                findings.append(
                    Finding(
                        mod.path,
                        line,
                        "GL301",
                        f"__all__ exports `{name}` but {mod.name} neither "
                        "defines nor imports it (stale export)",
                    )
                )
        if not mod.path.endswith("__init__.py"):
            continue
        all_names = {n for n, _ in all_entries}
        # re-exported symbols: from .sub import X at module top level
        for node in mod.tree.body:
            if not (isinstance(node, ast.ImportFrom) and node.module and node.level == 0):
                continue
            if node.module == "__future__":
                continue
            for alias in node.names:
                name = alias.asname or alias.name
                # module re-exports (from pkg import submodule) are reachable
                # without the __init__ and aren't surface drift
                if f"{node.module}.{alias.name}" in project.modules:
                    continue
                if name in all_names:
                    continue
                if (mod.name, name) in used:
                    continue
                # consumed inside the __init__ body itself (not a pure re-export)
                body_uses = any(
                    isinstance(n, ast.Name) and n.id == name and isinstance(n.ctx, ast.Load)
                    for top in mod.tree.body
                    if not isinstance(top, (ast.Import, ast.ImportFrom))
                    for n in ast.walk(top)
                )
                if body_uses:
                    continue
                findings.append(
                    Finding(
                        mod.path,
                        node.lineno,
                        "GL302",
                        f"`{name}` is re-exported by {mod.name} but is not in "
                        "__all__ and nothing imports it through the package — "
                        "dead surface (add it to __all__ or drop the re-export)",
                    )
                )
    return findings


def _handler_surfaces_error(handler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            leaf = name.split(".")[-1]
            if leaf in _LOGGISH:
                return True
            if any(kw.arg == "exc_info" for kw in node.keywords):
                return True
    return False


def check_swallows(project) -> list:
    findings = []
    for mod in project.modules.values():
        if ".controllers." not in f".{mod.name}.":
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            etype = node.type
            broad = etype is None or (
                isinstance(etype, ast.Name) and etype.id in ("Exception", "BaseException")
            ) or (
                isinstance(etype, ast.Tuple)
                and any(
                    isinstance(e, ast.Name) and e.id in ("Exception", "BaseException")
                    for e in etype.elts
                )
            )
            if broad and not _handler_surfaces_error(node):
                findings.append(
                    Finding(
                        mod.path,
                        node.lineno,
                        "GL303",
                        "broad `except Exception` in a controller path "
                        "swallows the error — log it, count it, or re-raise "
                        "(silent reconcile failures are undiagnosable)",
                    )
                )
    return findings


def check_drift(project) -> list:
    return check_exports(project) + check_swallows(project)
