"""GL5xx contract plane: whole-program enforcement of the repo's
hardest-won invariants — the ones previously pinned by brittle per-producer
tests and later hardening passes (CHANGES.md).

- GL501 env-knob discipline: every ``os.environ``/``os.getenv`` touch
  outside ``utils/envknobs.py`` is a finding (the trio owns empty-string/
  garbage/clamp semantics, and ``snapshot()`` is what replay capsules
  record — a stray read bypasses both). Separately, a ``KARPENTER_*``
  knob read reachable from a cache-fingerprint producer (a function that
  both ``CACHE.get(key)``-probes and ``CACHE[key] = ...``-fills a mapping
  on a locally-built key tuple) that does not flow into the key expression
  is a finding — the λ-not-in-fingerprint bug class (ops/tensorize.py's
  type-side cache was once fixed by hand; this rule makes the fix
  structural). Knobs read inside the observability planes (``obs.*``,
  ``operator.logging``) and the analyzer itself are excluded from the
  reachability closure: they steer recording, not solver outputs.
- GL502 closed-ledger enforcement: every ``record_decision(site, rung,
  reason)`` producer is checked against the ``SITES`` registry parsed
  from ``obs/decisions.py`` itself — literal sites/rungs/reasons
  directly; reason/rung *carriers* (a local name, a ``self.attr``
  refusal slot, a ``LAST_RUN["plan_refusal"]`` dict key) through every
  literal assigned to them; thin wrapper methods (``self._verdict``)
  through their call sites. This retires the hand-maintained enum-pin
  greps in tests/test_decisions.py. ``producer_census()`` self-reports
  coverage so the gate can prove every site has a checked producer.
- GL503 seam coverage: a function dispatching through the shared
  chunk/dispatch primitives (``dispatch_counterfactual_rows`` and
  friends, ``sharded_solve``) without a ``record_capture`` reachable
  from it is flagged — a new dispatch path can never silently escape
  replay. Literal seam names are validated against ``capsule.SEAMS``.
  The replay module itself (obs/capsule.py) is exempt: replaying a
  capture must not capture the replay.
- GL504 host-sync-in-dispatch-loop: a ``for``/``while`` loop that both
  dispatches device work (reaches a dispatch primitive) and blocks on it
  per iteration serializes the device — the static prerequisite for the
  one-device-program-per-round fusion (ROADMAP). The blocking verbs are
  the JAX package's (``.item()``, ``.block_until_ready()``,
  ``device_get``) and PyTorch's (``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``torch.cuda.synchronize``). Materialization *inside* the primitives is
  their contract and not flagged.

The port's copy of ``karpenter_tpu/analysis/contracts.py``: the dispatch
primitives are the port's functions of the same three names
(``ops/consolidate.py`` ``dispatch_counterfactual_rows`` and
``dispatch_counterfactual_rows_native``, ``parallel/mesh.py``
``sharded_solve``); only the sync verbs grow. All four rules are pure AST
passes over ``core.Project`` (stdlib-only, no torch import) riding the
same resolution machinery as the GL1xx taint pass.
Suppression follows the core grammar: ``# graftlint: disable=GL50x -- why``.
"""

from __future__ import annotations

import ast

from karpenter_tpu_torch.analysis.core import Finding, dotted

RULES = {
    "GL501": "os.environ/os.getenv touched outside utils/envknobs.py, or a KARPENTER_* knob reachable from a cache-fingerprint producer missing from its key",
    "GL502": "record_decision site/rung/reason outside the closed enums of obs/decisions.py SITES",
    "GL503": "dispatch through a shared chunk/dispatch primitive with no record_capture reachable (or an unknown capsule seam)",
    "GL504": "blocking host sync (.item()/.cpu()/.numpy()/.tolist()/.block_until_ready()/device_get/torch.cuda.synchronize) inside a loop that also dispatches device work",
}

# modules allowed to touch os.environ (the knob parser itself)
_ENV_HOME_SUFFIX = "utils.envknobs"
# the envknob accessor surface — calls with a literal KARPENTER_* first
# arg are "knob reads" for the fingerprint-coverage half of GL501
_KNOB_FUNCS = {"env_int", "env_float", "env_bool", "env_str"}
# knobs read inside these planes steer *recording*, not solver outputs —
# excluded from the fingerprint reachability closure (a trace-ring size
# must not have to appear in a tensor-cache key)
_CLOSURE_EXEMPT_SEGMENTS = {"obs", "analysis"}
_CLOSURE_EXEMPT_SUFFIXES = ("operator.logging",)

# the shared chunk/dispatch primitives every new dispatch path rides;
# callers must keep a record_capture reachable (GL503) and must not
# host-sync around them per loop iteration (GL504)
_DISPATCH_PRIMITIVES = {
    "dispatch_counterfactual_rows",
    "dispatch_counterfactual_rows_native",
    "sharded_solve",
}
_CAPTURE_FUNCS = {"record_capture"}
_SYNC_ATTRS = {"item", "block_until_ready", "cpu", "numpy", "tolist"}
_SYNC_FUNCS = {"device_get", "synchronize"}
# the replay half: re-executing a capture must not re-capture
_CAPSULE_SUFFIX = "obs.capsule"
_DECISIONS_SUFFIX = "obs.decisions"

_MAX_VALUE_DEPTH = 8
_FIXPOINT_ROUNDS = 24


def _segments(name: str) -> set:
    return set(name.split("."))


def _is_env_home(mod) -> bool:
    return mod.name.endswith(_ENV_HOME_SUFFIX) or mod.name == "envknobs"


def _closure_exempt(mod) -> bool:
    if _segments(mod.name) & _CLOSURE_EXEMPT_SEGMENTS:
        return True
    return any(mod.name.endswith(s) for s in _CLOSURE_EXEMPT_SUFFIXES)


# ---------------------------------------------------------------------------
# project index: functions, enclosing classes, light call resolution
# ---------------------------------------------------------------------------


class _Index:
    """Per-project function table + call resolution shared by the GL5xx
    passes: top-level functions, class methods (``self.m`` resolves within
    the enclosing class), and module-alias attribute calls."""

    def __init__(self, project):
        self.project = project
        self.fns: list = []  # (module, fn, class_name|None)
        self._methods: dict = {}  # (mod.name, class_name) -> {name: fn}
        self._imports: dict = {}  # mod.name -> resolve_imports result
        self._top: dict = {}  # mod.name -> {name: fn}
        self._fn_ctx: dict = {}  # id(fn) -> (module, class_name|None)
        for mod in project.modules.values():
            self._imports[mod.name] = project.resolve_imports(mod)
            self._top[mod.name] = project.top_level_functions(mod)
            encl: dict = {}

            def walk(node, cls_name):
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, ast.ClassDef):
                        walk(child, child.name)
                    elif isinstance(child, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                        encl[id(child)] = cls_name
                        if cls_name is not None:
                            self._methods.setdefault(
                                (mod.name, cls_name), {}
                            ).setdefault(child.name, child)
                        walk(child, cls_name)
                    else:
                        walk(child, cls_name)

            walk(mod.tree, None)
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    cls = encl.get(id(node))
                    self.fns.append((mod, node, cls))
                    self._fn_ctx[id(node)] = (mod, cls)

    def context(self, fn):
        return self._fn_ctx.get(id(fn))

    def methods(self, mod, cls_name) -> dict:
        return self._methods.get((mod.name, cls_name), {})

    def resolve(self, mod, cls_name, func_expr):
        """Callee expression -> (module, fn, class_name|None) | None."""
        if isinstance(func_expr, ast.Name):
            fn = self._top[mod.name].get(func_expr.id)
            if fn is not None:
                return mod, fn, None
            bound = self._imports[mod.name].get(func_expr.id)
            if bound is not None and bound[0] == "symbol":
                tmod, sym = bound[1], bound[2]
                fn = self._top[tmod.name].get(sym)
                if fn is not None:
                    return tmod, fn, None
        elif isinstance(func_expr, ast.Attribute):
            recv = func_expr.value
            if isinstance(recv, ast.Name):
                if recv.id in ("self", "cls") and cls_name is not None:
                    fn = self.methods(mod, cls_name).get(func_expr.attr)
                    if fn is not None:
                        return mod, fn, cls_name
                bound = self._imports[mod.name].get(recv.id)
                if bound is not None and bound[0] == "module":
                    tmod = bound[1]
                    fn = self._top[tmod.name].get(func_expr.attr)
                    if fn is not None:
                        return tmod, fn, None
        return None

    # -- per-function facts + transitive closures -------------------------

    def direct_calls(self, mod, fn, cls_name):
        """Yield (call_node, resolved|None, final_name) for every call in
        ``fn`` (nested defs included — over-approximate reachability)."""
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                resolved = self.resolve(mod, cls_name, node.func)
                final = dotted(node.func).split(".")[-1]
                yield node, resolved, final

    def transitive_flags(self, direct_of):
        """Generic bottom-up closure: ``direct_of(mod, fn, cls)`` returns
        this function's own contribution (a set); the result maps
        ``id(fn)`` to the union over everything reachable through
        resolved project-local calls."""
        facts = {}
        edges = {}
        for mod, fn, cls in self.fns:
            facts[id(fn)] = set(direct_of(mod, fn, cls))
            edges[id(fn)] = {
                id(r[1]) for _, r, _ in self.direct_calls(mod, fn, cls)
                if r is not None
            }
        for _ in range(_FIXPOINT_ROUNDS):
            changed = False
            for fid, callees in edges.items():
                for cid in callees:
                    extra = facts.get(cid, ())
                    if not set(extra) <= facts[fid]:
                        facts[fid] |= set(extra)
                        changed = True
            if not changed:
                break
        return facts


# ---------------------------------------------------------------------------
# knob reads
# ---------------------------------------------------------------------------


def _knob_of_call(node: ast.Call):
    """A call that reads one literal KARPENTER_* knob -> its name."""
    name = dotted(node.func)
    final = name.split(".")[-1]
    if final in _KNOB_FUNCS or name in ("os.getenv",) or name.endswith(
        "environ.get"
    ):
        if node.args and isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                node.args[0].value.startswith("KARPENTER_"):
            return node.args[0].value
    return None


def _direct_knobs(mod, fn) -> set:
    if _closure_exempt(mod) or _is_env_home(mod):
        return set()
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            k = _knob_of_call(node)
            if k is not None:
                out.add(k)
    return out


# ---------------------------------------------------------------------------
# GL501 — env-knob discipline
# ---------------------------------------------------------------------------


def _check_env_reads(project) -> list:
    findings = []
    for mod in project.modules.values():
        if _is_env_home(mod):
            continue
        for node in ast.walk(mod.tree):
            if (
                isinstance(node, ast.Attribute)
                and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id == "os"
            ):
                findings.append(Finding(
                    mod.path, node.lineno, "GL501",
                    "os.environ touched outside utils/envknobs.py — route "
                    "the knob through env_int/env_float/env_bool/env_str "
                    "(applied_env for writes) so parse/clamp semantics and "
                    "the replay env snapshot stay unified",
                ))
            elif isinstance(node, ast.Call) and dotted(node.func) in (
                "os.getenv", "getenv"
            ):
                findings.append(Finding(
                    mod.path, node.lineno, "GL501",
                    "os.getenv outside utils/envknobs.py — use the envknobs "
                    "accessors so knob semantics cannot drift",
                ))
    return findings


def _is_tuple_expr(expr) -> bool:
    return isinstance(expr, ast.Tuple) or (
        isinstance(expr, ast.Call) and dotted(expr.func) == "tuple"
    )


def _fingerprint_producers(mod, fn):
    """Yield (key_name, key_assigns, probe_line) for every cache pattern
    in ``fn``: a name K probed via ``D.get(K)`` and filled via
    ``D[K] = ...`` on the same receiver, with K built locally as a tuple
    (fingerprints are key tuples — string-keyed counters and pass-through
    keys are not fingerprints). A receiver rebuilt as a fresh ``{}`` dict
    literal inside the function is a per-call memo, not a persistent
    cache: the environment is constant within one call, so it is exempt."""
    probes: dict = {}  # (recv, key) -> line
    fills: set = set()
    assigns: dict = {}  # name -> [value exprs]
    memo_recvs: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" and node.args \
                and isinstance(node.args[0], ast.Name):
            recv = dotted(node.func.value)
            if recv:
                probes.setdefault((recv, node.args[0].id), node.lineno)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if node.value is None:
                continue
            for t in targets:
                if isinstance(t, ast.Subscript) and isinstance(
                    t.slice, ast.Name
                ):
                    recv = dotted(t.value)
                    if recv:
                        fills.add((recv, t.slice.id))
                elif isinstance(t, ast.Name):
                    assigns.setdefault(t.id, []).append(node.value)
                    if isinstance(node.value, ast.Dict):
                        memo_recvs.add(t.id)
    for (recv, key), line in probes.items():
        if recv in memo_recvs or (recv, key) not in fills:
            continue
        key_exprs = assigns.get(key, [])
        if any(_is_tuple_expr(e) for e in key_exprs):
            yield key, key_exprs, line


def _expr_knobs(index, mod, cls_name, expr, knob_closure) -> set:
    """Knobs covered by an expression: direct literal knob reads plus the
    transitive knob set of every resolved callee inside it."""
    out = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            k = _knob_of_call(node)
            if k is not None:
                out.add(k)
            resolved = index.resolve(mod, cls_name, node.func)
            if resolved is not None:
                out |= knob_closure.get(id(resolved[1]), set())
    return out


def _check_fingerprints(project, index, knob_closure) -> list:
    findings = []
    for mod, fn, cls in index.fns:
        if _closure_exempt(mod) or _is_env_home(mod):
            continue
        # local single-name assignments, for resolving key-tuple elements
        local_assigns: dict = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                local_assigns.setdefault(
                    node.targets[0].id, []
                ).append(node.value)
        for key, key_exprs, line in _fingerprint_producers(mod, fn):
            reachable = set(knob_closure.get(id(fn), set()))
            if not reachable:
                continue
            covered = set()
            for kexpr in key_exprs:
                covered |= _expr_knobs(index, mod, cls, kexpr, knob_closure)
                for node in ast.walk(kexpr):
                    if isinstance(node, ast.Name):
                        for rhs in local_assigns.get(node.id, ()):
                            covered |= _expr_knobs(
                                index, mod, cls, rhs, knob_closure
                            )
            missing = sorted(reachable - covered)
            if missing:
                findings.append(Finding(
                    mod.path, line, "GL501",
                    f"cache fingerprint `{key}` in `{fn.name}` omits "
                    f"knob(s) {', '.join(missing)} read on its compute "
                    "path — a knob flip would serve stale entries; fold "
                    "the knob value into the key tuple",
                ))
    return findings


# ---------------------------------------------------------------------------
# GL502 — closed-ledger enforcement
# ---------------------------------------------------------------------------


def _parse_sites(project):
    """The SITES registry parsed from obs/decisions.py's own AST (no
    import): {site: {"rungs": tuple, "reasons": set}}. None when the
    registry module is not part of the analyzed set (fixture runs that
    exercise other rules)."""
    for mod in project.modules.values():
        if not (mod.name.endswith(_DECISIONS_SUFFIX)
                or mod.name == "decisions"):
            continue
        consts: dict = {}
        sites_node = None
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                tname = node.targets[0].id
                if isinstance(node.value, ast.Constant) and isinstance(
                    node.value.value, str
                ):
                    consts[tname] = node.value.value
                if tname == "SITES":
                    sites_node = node.value
        if sites_node is None or not isinstance(sites_node, ast.Dict):
            continue

        def strs(node) -> set:
            out = set()
            if isinstance(node, ast.Call):  # frozenset({...})
                for a in node.args:
                    out |= strs(a)
            elif isinstance(node, (ast.Set, ast.Tuple, ast.List)):
                for e in node.elts:
                    out |= strs(e)
            elif isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                out.add(node.value)
            elif isinstance(node, ast.Name) and node.id in consts:
                out.add(consts[node.id])
            return out

        sites = {}
        for k, v in zip(sites_node.keys, sites_node.values):
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                continue
            if not isinstance(v, ast.Dict):
                continue
            spec = {"rungs": (), "reasons": set()}
            for fk, fv in zip(v.keys, v.values):
                if isinstance(fk, ast.Constant) and fk.value == "rungs":
                    spec["rungs"] = tuple(
                        e.value for e in getattr(fv, "elts", [])
                        if isinstance(e, ast.Constant)
                    )
                elif isinstance(fk, ast.Constant) and fk.value == "reasons":
                    spec["reasons"] = strs(fv)
            sites[k.value] = spec
        return sites
    return None


class _ValueScope:
    """Literal-string resolution for one expression site: function-local
    name assignments, module-wide attribute/dict-key writes, and
    module-level constants. Wrapper parameters surface as ("param", name)
    markers the caller substitutes."""

    def __init__(self, index, mod, fn, cls_name):
        self.index = index
        self.mod = mod
        self.fn = fn
        self.cls = cls_name
        self.params = set()
        if fn is not None:
            a = fn.args
            self.params = {p.arg for p in
                           (*a.posonlyargs, *a.args, *a.kwonlyargs)} - {
                               "self", "cls"}

    def _fn_assigns(self, name):
        if self.fn is None:
            return []
        out = []
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        out.append(node.value)
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and isinstance(node.target, ast.Name) \
                    and node.target.id == name:
                out.append(node.value)
        return out

    def _module_consts(self, name):
        out = []
        for node in self.mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    node.targets[0].id == name:
                out.append(node.value)
        return out

    def _attr_writes(self, attr):
        """Every ``<recv>.attr = rhs`` (and annotated/class-level form)
        anywhere in the module."""
        out = []
        for node in ast.walk(self.mod.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and t.attr == attr:
                        out.append(node.value)
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and isinstance(node.target, ast.Attribute) \
                    and node.target.attr == attr:
                out.append(node.value)
        return out

    def _key_writes(self, key):
        """Every ``D["key"] = rhs`` and ``D.update(key=rhs)`` in the
        module."""
        out = []
        for node in ast.walk(self.mod.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and isinstance(
                        t.slice, ast.Constant
                    ) and t.slice.value == key:
                        out.append(node.value)
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and node.func.attr == "update":
                for kw in node.keywords:
                    if kw.arg == key:
                        out.append(kw.value)
        return out

    def values(self, expr, depth=0, seen=None):
        """-> set of ("lit", value, line) | ("param", name, line)."""
        if seen is None:
            seen = set()
        if depth > _MAX_VALUE_DEPTH or expr is None:
            return set()
        line = getattr(expr, "lineno", 0)
        if isinstance(expr, ast.Constant):
            if isinstance(expr.value, str):
                return {("lit", expr.value, line)}
            return set()  # None / numbers: not label literals
        if isinstance(expr, ast.IfExp):
            return self.values(expr.body, depth + 1, seen) | \
                self.values(expr.orelse, depth + 1, seen)
        if isinstance(expr, ast.BoolOp):
            out = set()
            for v in expr.values:
                out |= self.values(v, depth + 1, seen)
            return out
        if isinstance(expr, ast.Name):
            if expr.id in self.params:
                return {("param", expr.id, line)}
            key = ("name", expr.id)
            if key in seen:
                return set()
            seen = seen | {key}
            out = set()
            for rhs in self._fn_assigns(expr.id) or \
                    self._module_consts(expr.id):
                out |= self.values(rhs, depth + 1, seen)
            return out
        if isinstance(expr, ast.Attribute):
            key = ("attr", expr.attr)
            if key in seen:
                return set()
            seen = seen | {key}
            out = set()
            for rhs in self._attr_writes(expr.attr):
                out |= self.values(rhs, depth + 1, seen)
            return out
        if isinstance(expr, ast.Subscript) and isinstance(
            expr.slice, ast.Constant
        ) and isinstance(expr.slice.value, str):
            return self._from_key(expr.slice.value, depth, seen)
        if isinstance(expr, ast.Call) and isinstance(
            expr.func, ast.Attribute
        ) and expr.func.attr == "get" and expr.args and isinstance(
            expr.args[0], ast.Constant
        ) and isinstance(expr.args[0].value, str):
            out = self._from_key(expr.args[0].value, depth, seen)
            if len(expr.args) > 1:
                out |= self.values(expr.args[1], depth + 1, seen)
            return out
        return set()

    def _from_key(self, key, depth, seen):
        mark = ("key", key)
        if mark in seen:
            return set()
        seen = seen | {mark}
        out = set()
        for rhs in self._key_writes(key):
            out |= self.values(rhs, depth + 1, seen)
        return out

    def tuple_values(self, expr, depth=0):
        """Resolve a *-splatted rung/reason carrier: every Tuple assigned
        to the name/attribute -> list of (rung_values, reason_values)."""
        sources = []
        if isinstance(expr, ast.Name):
            sources = self._fn_assigns(expr.id) or \
                self._module_consts(expr.id)
        elif isinstance(expr, ast.Attribute):
            sources = self._attr_writes(expr.attr)
        out = []
        for rhs in sources:
            if isinstance(rhs, ast.Tuple) and rhs.elts:
                rung = self.values(rhs.elts[0], depth + 1)
                reason = (self.values(rhs.elts[1], depth + 1)
                          if len(rhs.elts) > 1
                          else {("lit", "ok", rhs.lineno)})
                out.append((rung, reason))
        return out


def _ledger_calls(mod):
    """Yield every record_decision-style call in the module (final name
    ``record_decision``, or ``.record`` on a DECISIONS receiver)."""
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        final = name.split(".")[-1]
        if final == "record_decision":
            yield node
        elif final == "record" and name.split(".")[0] in ("DECISIONS",):
            yield node


def _call_args(node):
    """-> (site_expr, rung_expr, reason_expr, star_expr) with keyword
    forms folded in; missing reason means the "ok" default."""
    site = rung = reason = star = None
    pos = []
    for a in node.args:
        if isinstance(a, ast.Starred):
            star = a.value
            break
        pos.append(a)
    if len(pos) > 0:
        site = pos[0]
    if len(pos) > 1:
        rung = pos[1]
    if len(pos) > 2:
        reason = pos[2]
    for kw in node.keywords:
        if kw.arg == "site":
            site = kw.value
        elif kw.arg == "rung":
            rung = kw.value
        elif kw.arg == "reason":
            reason = kw.value
    return site, rung, reason, star


def _wrapper_callsites(index, mod, fn, cls_name):
    """Call sites of a producer wrapper: ``self.<name>``/``cls.<name>``
    within the enclosing class, bare-name calls module-wide."""
    out = []
    for wmod, wfn, wcls in index.fns:
        if wmod is not mod:
            continue
        for node in ast.walk(wfn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == fn.name and \
                    isinstance(f.value, ast.Name) and \
                    f.value.id in ("self", "cls") and wcls == cls_name:
                out.append((wmod, wfn, wcls, node))
            elif isinstance(f, ast.Name) and f.id == fn.name and \
                    cls_name is None:
                out.append((wmod, wfn, wcls, node))
    return out


def _substitute(index, wrapper_fn, call, param):
    """The argument expression a wrapper call site passes for ``param``
    (positional, keyword, or the wrapper's own default)."""
    a = wrapper_fn.args
    names = [p.arg for p in (*a.posonlyargs, *a.args)]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    for kw in call.keywords:
        if kw.arg == param:
            return kw.value
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            return None
        if i < len(names) and names[i] == param:
            return arg
    # defaults: align right over positional params
    defaults = a.defaults
    if defaults:
        defaulted = names[-len(defaults):]
        if param in defaulted:
            return defaults[defaulted.index(param)]
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if p.arg == param and d is not None:
            return d
    return None


def check_ledger(project, census=None) -> list:
    """GL502. When ``census`` (a dict) is passed, fills in the producer
    self-report: checked call sites, distinct sites covered, registry
    size."""
    sites = _parse_sites(project)
    findings: list = []
    producers = 0
    covered_sites: set = set()
    if sites is None:
        if census is not None:
            census.update(producers=0, sites_covered=[], site_count=0)
        return findings
    index = _Index(project)

    def validate(mod, line, site_name, rung_vals, reason_vals):
        spec = sites.get(site_name)
        if spec is None:
            findings.append(Finding(
                mod.path, line, "GL502",
                f"unknown decision site {site_name!r} — sites are a closed "
                "registry (obs/decisions.py SITES); add the site there "
                "first",
            ))
            return
        for kind, v, vline in sorted(rung_vals):
            if kind == "lit" and v not in spec["rungs"]:
                findings.append(Finding(
                    mod.path, vline or line, "GL502",
                    f"rung {v!r} is not in site {site_name!r}'s ladder "
                    f"{spec['rungs']} — rungs are code constants "
                    "(obs/decisions.py)",
                ))
        for kind, v, vline in sorted(reason_vals):
            if kind == "lit" and v not in spec["reasons"]:
                findings.append(Finding(
                    mod.path, vline or line, "GL502",
                    f"reason {v!r} is outside site {site_name!r}'s closed "
                    "enum — unknown reasons clamp to \"other\" at runtime; "
                    "add the cause to SITES[...]['reasons'] or use an "
                    "existing one",
                ))

    for mod in project.modules.values():
        if mod.name.endswith(_DECISIONS_SUFFIX) or mod.name == "decisions":
            continue  # the ledger's own forwarding shims
        for call in _ledger_calls(mod):
            ctx = None
            for fmod, ffn, fcls in index.fns:
                if fmod is mod and ffn.lineno <= call.lineno <= \
                        (ffn.end_lineno or ffn.lineno):
                    if ctx is None or ffn.lineno > ctx[1].lineno:
                        ctx = (fmod, ffn, fcls)
            fn = ctx[1] if ctx else None
            cls = ctx[2] if ctx else None
            scope = _ValueScope(index, mod, fn, cls)
            site_e, rung_e, reason_e, star_e = _call_args(call)
            site_vals = scope.values(site_e) if site_e is not None else set()
            site_lits = {v for k, v, _ in site_vals if k == "lit"}
            site_params = {v for k, v, _ in site_vals if k == "param"}

            def rr_vals():
                if star_e is not None:
                    pairs = scope.tuple_values(star_e)
                    rung_v = set().union(*[p[0] for p in pairs]) \
                        if pairs else set()
                    reason_v = set().union(*[p[1] for p in pairs]) \
                        if pairs else set()
                    return rung_v, reason_v
                rung_v = scope.values(rung_e) if rung_e is not None else set()
                reason_v = (scope.values(reason_e)
                            if reason_e is not None
                            else {("lit", "ok", call.lineno)})
                return rung_v, reason_v

            rung_vals, reason_vals = rr_vals()
            if site_lits and not site_params:
                producers += 1
                covered_sites |= site_lits
                for s in sorted(site_lits):
                    validate(mod, call.lineno, s, rung_vals, reason_vals)
                # wrapper half: rung/reason params resolve per call site
                wrapper_params = {v for k, v, _ in rung_vals | reason_vals
                                  if k == "param"}
                if wrapper_params and fn is not None:
                    for wmod, wfn, wcls, wcall in _wrapper_callsites(
                        index, mod, fn, cls
                    ):
                        wscope = _ValueScope(index, wmod, wfn, wcls)
                        producers += 1

                        def resolved(vals):
                            out = set()
                            for k, v, vline in vals:
                                if k == "lit":
                                    out.add((k, v, vline))
                                else:
                                    sub = _substitute(index, fn, wcall, v)
                                    if sub is not None:
                                        out |= wscope.values(sub)
                            return out

                        for s in sorted(site_lits):
                            validate(wmod, wcall.lineno, s,
                                     resolved(rung_vals),
                                     resolved(reason_vals))
            elif site_params and fn is not None:
                # site itself is a wrapper parameter: validate per caller
                for wmod, wfn, wcls, wcall in _wrapper_callsites(
                    index, mod, fn, cls
                ):
                    wscope = _ValueScope(index, wmod, wfn, wcls)
                    for p in site_params:
                        sub = _substitute(index, fn, wcall, p)
                        if sub is None:
                            continue
                        for k, v, _ in wscope.values(sub):
                            if k == "lit":
                                producers += 1
                                covered_sites.add(v)
                                validate(wmod, wcall.lineno, v,
                                         rung_vals, reason_vals)
    if census is not None:
        census.update(producers=producers,
                      sites_covered=sorted(covered_sites),
                      site_count=len(sites))
    return findings


# ---------------------------------------------------------------------------
# GL503 — seam coverage
# ---------------------------------------------------------------------------


def _parse_seams(project):
    for mod in project.modules.values():
        if mod.name.endswith(_CAPSULE_SUFFIX) or mod.name == "capsule":
            for node in mod.tree.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id == "SEAMS":
                    elts = getattr(node.value, "elts", [])
                    return tuple(e.value for e in elts
                                 if isinstance(e, ast.Constant))
    return None


def check_seams(project) -> list:
    findings: list = []
    index = _Index(project)
    seams = _parse_seams(project)

    captures = index.transitive_flags(
        lambda mod, fn, cls: {"capture"} if any(
            final in _CAPTURE_FUNCS
            for _, _, final in index.direct_calls(mod, fn, cls)
        ) else set()
    )

    for mod, fn, cls in index.fns:
        if mod.name.endswith(_CAPSULE_SUFFIX) or mod.name == "capsule":
            continue  # the replay half re-executes captures by design
        if fn.name in _DISPATCH_PRIMITIVES:
            continue  # the shared body itself; its CALLERS own the seam
        dispatch_call = None
        for node, _, final in index.direct_calls(mod, fn, cls):
            if final in _DISPATCH_PRIMITIVES:
                dispatch_call = node
                break
        if dispatch_call is None:
            continue
        if "capture" not in captures.get(id(fn), set()):
            findings.append(Finding(
                mod.path, dispatch_call.lineno, "GL503",
                f"`{fn.name}` dispatches through a shared chunk/dispatch "
                "primitive with no record_capture reachable — every "
                "dispatch path must register a capsule.SEAMS seam so an "
                "anomalous round stays replayable",
            ))

    if seams is not None:
        for mod in project.modules.values():
            if mod.name.endswith(_CAPSULE_SUFFIX) or mod.name == "capsule":
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call) and dotted(
                    node.func
                ).split(".")[-1] in _CAPTURE_FUNCS:
                    seam_e = node.args[0] if node.args else None
                    for kw in node.keywords:
                        if kw.arg == "seam":
                            seam_e = kw.value
                    if isinstance(seam_e, ast.Constant) and isinstance(
                        seam_e.value, str
                    ) and seam_e.value not in seams:
                        findings.append(Finding(
                            mod.path, node.lineno, "GL503",
                            f"capture seam {seam_e.value!r} is not in "
                            "capsule.SEAMS — seams are a closed registry "
                            "(obs/capsule.py); register the seam there "
                            "first",
                        ))
    return findings


# ---------------------------------------------------------------------------
# GL504 — host sync inside a dispatch loop
# ---------------------------------------------------------------------------


def _sync_verb(node):
    """A blocking host-sync call -> short description, else None."""
    if not isinstance(node, ast.Call):
        return None
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in _SYNC_ATTRS:
        return f".{node.func.attr}()"
    name = dotted(node.func)
    if name.split(".")[-1] in _SYNC_FUNCS:
        return f"{name}()"
    return None


def check_dispatch_loops(project) -> list:
    findings: list = []
    index = _Index(project)
    dispatches = index.transitive_flags(
        lambda mod, fn, cls: {"dispatch"} if any(
            final in _DISPATCH_PRIMITIVES
            for _, _, final in index.direct_calls(mod, fn, cls)
        ) else set()
    )

    for mod, fn, cls in index.fns:
        if mod.name.endswith(_CAPSULE_SUFFIX) or mod.name == "capsule":
            continue  # offline replay re-executes dispatches host-side
        if fn.name in _DISPATCH_PRIMITIVES:
            continue  # chunk-internal materialization is the contract
        for loop in ast.walk(fn):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            dispatching = False
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                final = dotted(node.func).split(".")[-1]
                if final in _DISPATCH_PRIMITIVES:
                    dispatching = True
                    break
                resolved = index.resolve(mod, cls, node.func)
                if resolved is not None and "dispatch" in dispatches.get(
                    id(resolved[1]), set()
                ):
                    dispatching = True
                    break
            if not dispatching:
                continue
            for node in ast.walk(loop):
                verb = _sync_verb(node)
                if verb is not None:
                    findings.append(Finding(
                        mod.path, node.lineno, "GL504",
                        f"`{verb}` inside a loop that also dispatches "
                        f"device work (`{fn.name}`) serializes the device "
                        "per iteration — batch the rows into one dispatch "
                        "or hoist the sync past the loop",
                    ))
    return findings


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def producer_census(project) -> dict:
    """GL502's self-report: how many record_decision producers the pass
    actually checked, and which sites they cover. The tier-1 gate asserts
    ``producers >= site_count`` so registry growth without a checked
    producer (or a producer pattern the pass stopped seeing) fails
    loudly."""
    census: dict = {}
    check_ledger(project, census=census)
    return census


def check_contracts(project) -> list:
    index = _Index(project)
    knob_closure = index.transitive_flags(
        lambda mod, fn, cls: _direct_knobs(mod, fn)
    )
    findings = _check_env_reads(project)
    findings += _check_fingerprints(project, index, knob_closure)
    findings += check_ledger(project)
    findings += check_seams(project)
    findings += check_dispatch_loops(project)
    return findings
