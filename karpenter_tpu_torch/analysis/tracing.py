"""GL1xx device-queue safety + GL4xx observability safety for the port.

The port's copy of ``karpenter_tpu/analysis/tracing.py``, given a PyTorch
meaning. The JAX package's entries are the functions handed to
``jax.jit`` / ``pl.pallas_call``; the port has neither. Its counterpart of
"traced code" is the set of functions that queue work on the card, named
in one table, ``DEVICE_ENTRIES``: ``ops/kernels.py`` ``solve_step``,
``probe_step``, ``_pack`` and ``_feasibility``; ``ops/cuda_kernels.py``
``compat``; and the PDHG loops of ``ops/relax.py`` (``floor_lb``,
``joint_lp``). Every parameter of an entry carries tensors except the
static ones the table lists, the result of a ``torch.*`` call is a
tensor, state a loop rebinds to a tensor is one where the next iteration
reads it, and the taint follows calls into package-local functions as in
the JAX package's pass. Inside
anything reachable from an entry, the silent failure mode is a host read:
a dispatch is feasibility's two compat launches and one pack launch,
queued without a wait so that its device time lies in the one readback
(``solve.block``), and a read in between blocks the host until the card
drains its queue, so the next launches wait on it.

- GL101 host-read: ``.item()`` / ``.cpu()`` / ``.numpy()`` / ``.tolist()``
  on a tensor, ``float()`` / ``int()`` / ``bool()`` / ``np.asarray()`` on
  a tensor, or a Python ``if``/``while``/``assert``/conditional
  expression on one (an implicit ``bool()``). A read the port makes by
  design carries ``# graftlint: disable=GL101 -- why``.
- GL102 and GL103 are reserved and never emitted. GL102 (a branch on a
  traced value) has no meaning of its own under eager PyTorch: a branch
  on a tensor is an implicit ``bool()``, which GL101 reports. GL103
  (trace-time side effects) has none either: an eager function runs its
  ``print``/``logging``/``os.environ`` reads on every call, nothing
  freezes into a compiled program (GL501 keeps the env reads in
  ``utils/envknobs.py``).
- GL104 compile-in-loop: ``torch.compile`` / ``torch.jit.script`` /
  ``torch.jit.trace`` called inside a loop body builds a fresh wrapper
  (and recompiles) every iteration.

The GL4xx family rides the same reachability pass and keeps the planes
(``karpenter_tpu_torch/obs``) off the device queue: a span, recorder,
device-plane, decision, capsule or timeline call inside the pack loop
would run once per group row, take the planes' locks and read clocks
between launches, and record per-row noise as if it were a round's:

- GL401 span-in-entry: ``span(...)`` / ``round_trace(...)`` (bare or as
  the last attribute of any chain — ``obs.span``, ``TRACER.span``).
- GL402 recorder-in-entry: ``anomaly(...)`` / ``record_anomaly(...)``,
  plus ``record``/``dump`` invoked on an obs-plane object (``obs.*``,
  ``RECORDER``/``recorder``/``TRACER``/``tracer``/``FLIGHT_RECORDER``).
- GL403 devplane-in-entry: ``record_dispatch``/``record_padding``/
  ``record_compile``, or ``observe`` on a devplane receiver
  (``devplane.*``/``LEDGER``/``ledger``).
- GL404 decision-ledger-in-entry: ``record_decision``/``record_quality``/
  ``note_round``, or ``record``/``observe_quality`` on a decisions
  receiver (``decisions.*``/``DECISIONS``).
- GL405 capsule-in-entry: ``record_capture``/``write_capsule``/
  ``maybe_write_round``, or ``capture`` on a capsule receiver.
- GL406 timeline-in-entry: ``record_event``/``record_billing``/
  ``note_launch``/``begin_command``/``observe_fleet``, or ``record``/
  ``observe``/``note`` on a timeline receiver (``timeline.*``/
  ``TIMELINE``).

Shape reads (``x.shape``/``ndim``/``dtype``/``device``/``is_cuda``,
``x.numel()``/``x.size()``/``x.dim()``/``x.data_ptr()``, ``len()``) and
structure tests (``is None``, ``in``, ``isinstance``) are host-static and
exempt.
"""

from __future__ import annotations

import ast

from karpenter_tpu_torch.analysis.core import Finding, dotted

RULES = {
    "GL101": "host read (.item()/.cpu()/.numpy()/.tolist()/float()/int()/bool()/np.asarray/a branch) of a tensor in code that queues device work",
    "GL102": "reserved: a branch on a tensor is an implicit bool(), reported as GL101",
    "GL103": "reserved: eager PyTorch has no trace time to freeze a side effect into",
    "GL104": "torch.compile/torch.jit.script/torch.jit.trace called inside a loop recompiles every iteration",
    "GL401": "obs tracer span enter/exit (span/round_trace) in code that queues device work",
    "GL402": "obs flight-recorder mutation (anomaly/record/dump) in code that queues device work",
    "GL403": "devplane telemetry hook (compile ledger / pad-waste / SLO observe) in code that queues device work",
    "GL404": "decision-ledger hook (record_decision / record_quality / decisions receiver) in code that queues device work",
    "GL405": "replay-capsule hook (record_capture / write_capsule / capsule receiver) in code that queues device work",
    "GL406": "fleet-ledger timeline hook (record_event / record_billing / timeline receiver) in code that queues device work",
}

# the functions that queue work on the card — the port's counterpart of
# the JAX package's jax.jit / pl.pallas_call entries: module (relative to
# the package) -> {function: parameters that carry no tensor}
DEVICE_ENTRIES = {
    "ops.kernels": {
        "solve_step": {"max_bins", "with_existing", "level_bits",
                       "max_minv", "fma_rem"},
        "probe_step": {"max_bins", "max_minv", "level_bits"},
        "_pack": set(),
        "_feasibility": set(),
    },
    "ops.cuda_kernels": {"compat": set()},
    "ops.relax": {
        "floor_lb": {"max_iters", "tol", "rho"},
        "joint_lp": {"max_iters", "tol", "rho", "with_y"},
    },
}

_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                 "is_cpu", "layout"}
# tensor methods whose result is host metadata, not a device value
_HOST_METHODS = {"numel", "nelement", "dim", "size", "stride", "data_ptr",
                 "element_size", "get_device", "is_contiguous",
                 "is_floating_point"}
# tensor methods that read the value back to the host
_READ_METHODS = {"item", "cpu", "numpy", "tolist"}
_HOST_RESULT_FUNCS = {"len", "isinstance", "type", "id", "hash"}
_CAST_FUNCS = {"float", "int", "bool", "complex"}
_NUMPY_ALIASES = {"np", "_np", "numpy", "onp"}
_COMPILE_NAMES = {"torch.compile", "torch.jit.script", "torch.jit.trace"}
_TORCH_HOST_FUNCS = {"torch.device", "torch.Size", "torch.finfo",
                     "torch.iinfo", "torch.is_tensor",
                     "torch.get_default_dtype"}
_TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.jit.")
# GL4xx — the obs flight-recorder surface (karpenter_tpu/obs). Span entry
# is matched by final name so `obs.span`, `TRACER.span`, and a bare
# imported `span` all hit; the generic `record`/`dump` verbs only count
# when invoked on an unmistakably obs-plane receiver.
_SPAN_FUNCS = {"span", "round_trace"}
_ANOMALY_FUNCS = {"anomaly", "record_anomaly"}
_RECORDER_VERBS = {"record", "dump"}
_OBS_BASES = {"obs", "TRACER", "tracer", "RECORDER", "recorder",
              "FLIGHT_RECORDER"}
# GL403 — the device-plane telemetry surface (karpenter_tpu/obs/devplane):
# the hook names are matched by final attribute (devplane.record_dispatch,
# LEDGER.record_dispatch, a bare import); the generic `observe` verb only
# counts on an unmistakably devplane receiver.
_DEVPLANE_FUNCS = {"record_dispatch", "record_padding", "record_compile"}
_DEVPLANE_VERBS = {"observe"}
_DEVPLANE_BASES = {"devplane", "LEDGER", "ledger"}
# GL404 — the decision-ledger surface (karpenter_tpu/obs/decisions): the
# hook names match by final attribute (decisions.record_decision,
# DECISIONS.record, a bare import); the generic `record`/`observe_quality`
# verbs only count on an unmistakably decisions receiver.
_DECISION_FUNCS = {"record_decision", "record_quality", "note_round"}
_DECISION_VERBS = {"record", "observe_quality"}
_DECISION_BASES = {"decisions", "DECISIONS"}
# GL405 — the replay-capsule surface (karpenter_tpu/obs/capsule): the
# capture/serialize hooks match by final attribute (capsule.record_capture,
# a bare import); the generic `capture` verb only counts on an
# unmistakably capsule receiver.
_CAPSULE_FUNCS = {"record_capture", "write_capsule", "maybe_write_round"}
_CAPSULE_VERBS = {"capture"}
_CAPSULE_BASES = {"capsule", "CAPSULES"}
# GL406 — the fleet-ledger timeline surface (karpenter_tpu/obs/timeline):
# the event/billing hooks match by final attribute (timeline.record_event,
# TIMELINE.record_billing, a bare import); the generic verbs only count on
# an unmistakably timeline receiver.
_TIMELINE_FUNCS = {"record_event", "record_billing", "note_launch",
                   "begin_command", "observe_fleet"}
_TIMELINE_VERBS = {"record", "observe", "note"}
_TIMELINE_BASES = {"timeline", "TIMELINE"}


def _param_names(fn) -> list:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


class _FunctionEnv:
    """Name resolution for one function: nested defs of the lexical chain,
    module top-level functions, then imports."""

    def __init__(self, project, module, chain):
        self.project = project
        self.module = module
        self.chain = chain  # enclosing FunctionDefs, outermost first
        self.imports = project.resolve_imports(module)
        self.top = project.top_level_functions(module)

    def local_defs(self) -> dict:
        defs = {}
        for fn in self.chain:
            for node in ast.walk(fn):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    defs.setdefault(node.name, node)
        return defs

    def resolve(self, func_node):
        """A callee expression -> (module, FunctionDef, chain) | None."""
        if isinstance(func_node, ast.Name):
            local = self.local_defs().get(func_node.id)
            if local is not None:
                return self.module, local, self.chain
            top = self.top.get(func_node.id)
            if top is not None:
                return self.module, top, []
            bound = self.imports.get(func_node.id)
            if bound is not None and bound[0] == "symbol":
                mod, sym = bound[1], bound[2]
                fn = self.project.top_level_functions(mod).get(sym)
                if fn is not None:
                    return mod, fn, []
        elif isinstance(func_node, ast.Attribute) and isinstance(func_node.value, ast.Name):
            bound = self.imports.get(func_node.value.id)
            if bound is not None and bound[0] == "module":
                fn = self.project.top_level_functions(bound[1]).get(func_node.attr)
                if fn is not None:
                    return bound[1], fn, []
        return None


def _makes_tensor(fname: str) -> bool:
    """Whether a call of ``fname`` returns a tensor: any ``torch.*``
    function but the host-side ones (devices, sizes, dtype info, the CUDA
    runtime's controls)."""
    if not fname.startswith("torch."):
        return False
    if fname.startswith(_TORCH_HOST_PREFIXES):
        return False
    return fname not in _TORCH_HOST_FUNCS


def _entry_table(mod) -> dict:
    """The ``DEVICE_ENTRIES`` row of a module (by its name relative to the
    package, or the bare name in fixtures), else {}."""
    for suffix, table in DEVICE_ENTRIES.items():
        if mod.name == suffix or mod.name.endswith("." + suffix):
            return table
    return {}


def _find_entries(project):
    """Yield (module, FunctionDef, chain, tensor_param_names)."""
    for mod in project.modules.values():
        top = project.top_level_functions(mod)
        for name, static in _entry_table(mod).items():
            fn = top.get(name)
            if fn is not None:
                yield mod, fn, [], [p for p in _param_names(fn)
                                    if p not in static]


class _TaintVisitor:
    """One traced function body: propagate taint, emit findings, collect
    call edges into other package-local functions."""

    def __init__(self, project, module, fn, chain, traced, free_tainted):
        self.project = project
        self.module = module
        self.fn = fn
        self.env = _FunctionEnv(project, module, chain + [fn])
        self.tainted = set(traced) | set(free_tainted)
        self.findings: list = []
        self.edges: list = []  # (module, fn, chain, traced_params, free_tainted)
        self._seen_lines: set = set()

    # -- taint ------------------------------------------------------------
    def is_tainted(self, node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            fname = dotted(node.func)
            base = fname.split(".")[0]
            if base in _HOST_RESULT_FUNCS or fname in _CAST_FUNCS:
                return False
            if isinstance(node.func, ast.Attribute) and (
                    node.func.attr in _READ_METHODS
                    or node.func.attr in _HOST_METHODS):
                return False  # a host read (flagged) or host metadata
            if base in _NUMPY_ALIASES and fname.split(".")[-1] in ("asarray", "array"):
                return False  # host pull: flagged, result is host-side
            if _makes_tensor(fname):
                return True  # a torch function's result is a tensor
            args = list(node.args) + [kw.value for kw in node.keywords]
            if isinstance(node.func, ast.Attribute) and self.is_tainted(node.func.value):
                return True  # method on a tensor
            return any(self.is_tainted(a) for a in args)
        if isinstance(node, (ast.BinOp,)):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # identity/membership tests are host bools
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return False
            return self.is_tainted(node.left) or any(
                self.is_tainted(c) for c in node.comparators
            )
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.is_tainted(v) for v in node.values if v is not None)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.is_tainted(node.elt) or any(
                self.is_tainted(g.iter) for g in node.generators
            )
        if isinstance(node, ast.DictComp):
            return (
                self.is_tainted(node.key)
                or self.is_tainted(node.value)
                or any(self.is_tainted(g.iter) for g in node.generators)
            )
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        return False

    def _bind_targets(self, target, tainted: bool):
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind_targets(elt, tainted)
        elif isinstance(target, ast.Starred):
            self._bind_targets(target.value, tainted)
        # attribute/subscript stores don't rebind names

    def propagate(self, emit: bool):
        self._emit = emit
        for stmt in self.fn.body:
            self._stmt(stmt)

    def _stmt(self, node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs analyzed when referenced/called
        if isinstance(node, ast.Assign):
            t = self.is_tainted(node.value)
            self._expr(node.value)
            for target in node.targets:
                self._bind_targets(target, t)
            # comprehension loop vars over traced iterables (e.g. dict
            # .items() of the traced arg dict) taint their element names
            return
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            t = self.is_tainted(node.value)
            self._expr(node.value)
            self._bind_targets(node.target, t)
            return
        if isinstance(node, ast.AugAssign):
            t = self.is_tainted(node.value) or self.is_tainted(node.target)
            self._expr(node.value)
            self._bind_targets(node.target, t)
            return
        if isinstance(node, ast.If):
            self._branch_check(node.test, "if")
            self._expr(node.test)
            for s in node.body + node.orelse:
                self._stmt(s)
            return
        if isinstance(node, ast.While):
            self._loop_body(node.body)
            self._branch_check(node.test, "while")
            self._expr(node.test)
            for s in node.body + node.orelse:
                self._stmt(s)
            return
        if isinstance(node, ast.Assert):
            self._branch_check(node.test, "assert")
            self._expr(node.test)
            return
        if isinstance(node, ast.For):
            self._expr(node.iter)
            self._bind_targets(node.target, self.is_tainted(node.iter))
            self._loop_body(node.body)
            for s in node.body + node.orelse:
                self._stmt(s)
            return
        if isinstance(node, ast.With):
            for item in node.items:
                self._expr(item.context_expr)
                if item.optional_vars is not None:
                    self._bind_targets(
                        item.optional_vars, self.is_tainted(item.context_expr)
                    )
            for s in node.body:
                self._stmt(s)
            return
        if isinstance(node, ast.Try):
            for s in node.body + node.orelse + node.finalbody:
                self._stmt(s)
            for handler in node.handlers:
                for s in handler.body:
                    self._stmt(s)
            return
        if hasattr(ast, "Match") and isinstance(node, ast.Match):
            self._branch_check(node.subject, "match")
            self._expr(node.subject)
            for case in node.cases:
                for s in case.body:
                    self._stmt(s)
            return
        if isinstance(node, ast.Return) and node.value is not None:
            self._expr(node.value)
            return
        if isinstance(node, ast.Expr):
            self._expr(node.value)
            return
        if isinstance(node, ast.Global):
            return
        # default: walk any embedded expressions
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child)
            elif isinstance(child, ast.stmt):
                self._stmt(child)

    def _loop_body(self, body):
        """A silent pass over a loop body before the real one, so state
        an iteration rebinds to a tensor (the eager pack loop's bins,
        created before the loop by a local helper) is a tensor where the
        next iteration reads it."""
        emit, self._emit = self._emit, False
        for s in body:
            self._stmt(s)
        self._emit = emit

    # -- checks -----------------------------------------------------------
    def _branch_flaggable(self, test) -> bool:
        if isinstance(test, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in test.ops):
                return False  # structure checks are host-static
            return self.is_tainted(test)
        if isinstance(test, ast.Call) and dotted(test.func) in ("isinstance", "hasattr", "callable"):
            return False
        if isinstance(test, ast.BoolOp):
            return any(self._branch_flaggable(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._branch_flaggable(test.operand)
        return self.is_tainted(test)

    def _branch_check(self, test, kind: str):
        if self._branch_flaggable(test):
            self._flag(
                "GL101",
                test.lineno,
                f"Python `{kind}` on a tensor inside `{self.fn.name}` "
                "(reachable from a device entry) is an implicit bool(): "
                "a device->host read",
            )

    def _flag(self, rule, line, message):
        if not self._emit:
            return
        key = (rule, line)
        if key in self._seen_lines:
            return
        self._seen_lines.add(key)
        self.findings.append(Finding(self.module.path, line, rule, message))

    def _expr(self, node):
        for call in [n for n in ast.walk(node) if isinstance(n, ast.Call)]:
            self._call(call)
        if self._emit:
            for sub in ast.walk(node):
                if isinstance(sub, ast.IfExp):
                    self._branch_check(sub.test, "conditional expression")

    def _call(self, node):
        fname = dotted(node.func)
        base = fname.split(".")[0]
        args = list(node.args) + [kw.value for kw in node.keywords]

        # GL101 host reads
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _READ_METHODS):
            if self.is_tainted(node.func.value):
                self._flag(
                    "GL101",
                    node.lineno,
                    f"`.{node.func.attr}()` on a tensor inside "
                    f"`{self.fn.name}` (reachable from a device entry) "
                    "reads it back to the host",
                )
        elif fname in _CAST_FUNCS and any(self.is_tainted(a) for a in args):
            self._flag(
                "GL101",
                node.lineno,
                f"`{fname}()` on a tensor inside `{self.fn.name}` "
                "(reachable from a device entry) reads it back to the host",
            )
        elif (
            base in _NUMPY_ALIASES
            and fname.split(".")[-1] in ("asarray", "array")
            and any(self.is_tainted(a) for a in args)
        ):
            self._flag(
                "GL101",
                node.lineno,
                f"`{fname}()` on a tensor inside `{self.fn.name}` "
                "(reachable from a device entry) pulls it to the host",
            )

        # GL4xx — a plane's call reachable from a device entry runs
        # between launches, once per step of the loop that queues them.
        # Matches the module-level helpers AND any attribute spelling
        # (obs.span / TRACER.span / self._tracer.span).
        last = fname.split(".")[-1] if fname else ""
        if last in _SPAN_FUNCS:
            self._flag(
                "GL401",
                node.lineno,
                f"tracer span `{fname}(...)` inside `{self.fn.name}` "
                "(reachable from a device entry) — hoist the span to the "
                "dispatch site",
            )
        elif last in _ANOMALY_FUNCS or (
            last in _RECORDER_VERBS and base in _OBS_BASES
        ):
            self._flag(
                "GL402",
                node.lineno,
                f"flight-recorder call `{fname}(...)` inside "
                f"`{self.fn.name}` (reachable from a device entry) — mark "
                "anomalies from the caller",
            )
        elif last in _DEVPLANE_FUNCS or (
            last in _DEVPLANE_VERBS and base in _DEVPLANE_BASES
        ):
            self._flag(
                "GL403",
                node.lineno,
                f"devplane telemetry hook `{fname}(...)` inside "
                f"`{self.fn.name}` (reachable from a device entry) — "
                "record from the dispatch site",
            )
        elif last in _DECISION_FUNCS or (
            last in _DECISION_VERBS and base in _DECISION_BASES
        ):
            self._flag(
                "GL404",
                node.lineno,
                f"decision-ledger hook `{fname}(...)` inside "
                f"`{self.fn.name}` (reachable from a device entry) — "
                "record the verdict from the ladder site",
            )
        elif last in _CAPSULE_FUNCS or (
            last in _CAPSULE_VERBS and base in _CAPSULE_BASES
        ):
            self._flag(
                "GL405",
                node.lineno,
                f"replay-capsule hook `{fname}(...)` inside "
                f"`{self.fn.name}` (reachable from a device entry) — "
                "capture from the dispatch site",
            )
        elif last in _TIMELINE_FUNCS or (
            last in _TIMELINE_VERBS and base in _TIMELINE_BASES
        ):
            self._flag(
                "GL406",
                node.lineno,
                f"fleet-ledger timeline hook `{fname}(...)` inside "
                f"`{self.fn.name}` (reachable from a device entry) — "
                "record lifecycle events from the controller",
            )

        # call edges into package-local functions
        resolved = self.env.resolve(node.func)
        if resolved is not None:
            tmod, fn, fchain = resolved
            params = _param_names(fn)
            traced = set()
            for i, a in enumerate(node.args):
                if isinstance(a, ast.Starred):
                    if self.is_tainted(a.value):
                        traced |= set(params[i:])
                    break
                if i < len(params) and self.is_tainted(a):
                    traced.add(params[i])
            for kw in node.keywords:
                if kw.arg is not None and kw.arg in params and self.is_tainted(kw.value):
                    traced.add(kw.arg)
                elif kw.arg is None and self.is_tainted(kw.value):
                    traced |= set(params)  # **kwargs splat of traced dict
            free = set()
            if tmod is self.module and fchain:
                # nested sibling: free variables of the enclosing chain
                free = self.tainted & _free_names(fn)
            self.edges.append((tmod, fn, fchain, frozenset(traced), frozenset(free)))
        # package-local function VALUES handed to another call (a
        # combinator or a callback): every parameter carries tensors
        for a in node.args:
            if isinstance(a, (ast.Name, ast.Attribute)) and a is not node.func:
                r = self.env.resolve(a)
                if r is not None:
                    tmod, fn, fchain = r
                    free = self.tainted & _free_names(fn) if tmod is self.module else set()
                    self.edges.append(
                        (tmod, fn, fchain, frozenset(_param_names(fn)), frozenset(free))
                    )


def _free_names(fn) -> set:
    bound = set(_param_names(fn))
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.add(node.id)
    loads = {
        n.id
        for n in ast.walk(fn)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
    }
    return loads - bound


def _analyze_traced(project, module, fn, chain, traced, free_tainted):
    v = _TaintVisitor(project, module, fn, chain, traced, free_tainted)
    # taint fixpoint (loop-carried rebinds), then one emitting pass
    for _ in range(4):
        before = set(v.tainted)
        v.propagate(emit=False)
        if v.tainted == before:
            break
    v.edges = []
    v._seen_lines = set()
    v.propagate(emit=True)
    return v.findings, v.edges


def check_tracing(project) -> list:
    findings: list = []
    seen: set = set()
    work = [
        (mod, fn, chain, frozenset(traced), frozenset())
        for mod, fn, chain, traced in _find_entries(project)
    ]
    while work:
        mod, fn, chain, traced, free = work.pop()
        key = (mod.name, fn.lineno, fn.name, traced, free)
        if key in seen:
            continue
        seen.add(key)
        f, edges = _analyze_traced(project, mod, fn, chain, list(traced), list(free))
        findings.extend(f)
        for tmod, tfn, tchain, ttraced, tfree in edges:
            work.append((tmod, tfn, tchain, ttraced, tfree))

    # GL104: compile wrappers built inside loops — everywhere, reachable
    # or not (the storm is a host-side structure bug)
    for mod in project.modules.values():
        loop_stack: list = []

        def visit(node):
            is_loop = isinstance(node, (ast.For, ast.While))
            if is_loop:
                loop_stack.append(node)
            if isinstance(node, ast.Call):
                name = dotted(node.func)
                if name in _COMPILE_NAMES and loop_stack:
                    findings.append(
                        Finding(
                            mod.path,
                            node.lineno,
                            "GL104",
                            f"`{name}(...)` constructed inside a loop builds a "
                            "fresh wrapper (and recompiles) every iteration; "
                            "hoist it and cache the compiled callable",
                        )
                    )
            for child in ast.iter_child_nodes(node):
                visit(child)
            if is_loop:
                loop_stack.pop()

        visit(mod.tree)
    return findings
