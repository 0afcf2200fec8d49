"""GL2xx — lock discipline for classes owning a threading.Lock/RLock.

The concurrent surfaces (kube/store.py's apiserver analog, the metrics
registry, the fake cloud provider, the fake clock) all follow the same
convention: ``self._lock`` created in ``__init__``, every mutation of the
shared dicts/lists inside ``with self._lock``. These rules keep that
convention honest:

- GL201 unguarded-mutation: an attribute that is mutated under the lock
  somewhere in the class (so it IS guarded state) is also mutated in a
  method that neither holds the lock nor is provably only called from
  lock-held code paths within the class.
- GL202 lock-order-cycle: class A's methods acquire B's lock while holding
  A's (via a composed attribute typed by construction in ``__init__``) and
  vice versa — the classic ABBA deadlock, detected as a cycle in the
  holds-while-acquiring graph.
- GL203 self-deadlock: while holding a plain (non-reentrant)
  ``threading.Lock``, calling another method of the same class that
  re-acquires it — blocks forever at runtime; only RLock owners may
  re-enter.

``__init__`` is exempt from GL201 (the object is not yet shared while it
is being constructed), and reads are never flagged — the rules target lost
updates, not stale reads.
"""

from __future__ import annotations

import ast

from karpenter_tpu_torch.analysis.core import Finding, dotted

RULES = {
    "GL201": "mutation of lock-guarded state without holding the class lock",
    "GL202": "lock-acquisition-order cycle across classes (ABBA deadlock)",
    "GL203": "re-acquiring a non-reentrant Lock from a method already holding it",
}

_MUTATORS = {
    "append", "extend", "insert", "add", "update", "setdefault", "pop",
    "popitem", "remove", "discard", "clear", "appendleft", "popleft",
}
_LOCK_CTORS = {"Lock", "RLock", "threading.Lock", "threading.RLock"}


def _lock_attrs(cls) -> dict:
    """self.X = threading.Lock()/RLock() (or an alias of another object's
    lock) anywhere in the class -> {attr: "lock"|"rlock"|"alias"}."""
    out: dict = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if not (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                continue
            name = dotted(node.value)
            if isinstance(node.value, ast.Call) and name in _LOCK_CTORS:
                out[target.attr] = "rlock" if name.endswith("RLock") else "lock"
            elif (
                isinstance(node.value, ast.Attribute)
                and "lock" in node.value.attr.lower()
            ):
                out[target.attr] = "alias"
    return out


def _methods(cls) -> dict:
    return {
        n.name: n
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _is_self_attr(node, attrs) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and node.attr in attrs
    ):
        return node.attr
    return None


def _lock_items(node, lock_attrs) -> set:
    """Which class locks does this With statement acquire?"""
    acquired = set()
    for item in node.items:
        attr = _is_self_attr(item.context_expr, lock_attrs)
        if attr:
            acquired.add(attr)
    return acquired


def _walk_with_lock(fn, lock_attrs):
    """Yield (node, held) for every statement/expr node in fn, where held
    is the SET of class lock attrs held at that point — identity matters:
    holding self._a guards nothing that self._b guards, and calling into a
    self._b acquirer while holding self._a deadlocks nobody."""

    def rec(node, held):
        yield node, held
        if isinstance(node, ast.With):
            acquired = _lock_items(node, lock_attrs)
            if acquired:
                held = held | acquired
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            yield from rec(child, held)

    for stmt in fn.body:
        yield from rec(stmt, frozenset())


def _mutations(fn, lock_attrs):
    """Yield (attr, line, held_locks) for self-attribute mutations."""
    for node, held in _walk_with_lock(fn, lock_attrs):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for leaf in _assign_leaves(t):
                    attr = _mutated_attr(leaf)
                    if attr:
                        yield attr, node.lineno, held
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _mutated_attr(t)
                if attr:
                    yield attr, node.lineno, held
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATORS:
                attr = _receiver_attr(node.func.value)
                if attr:
                    yield attr, node.lineno, held


def _assign_leaves(target):
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _assign_leaves(elt)
    elif isinstance(target, ast.Starred):
        yield from _assign_leaves(target.value)
    else:
        yield target


def _mutated_attr(target) -> str | None:
    """self.X = / self.X[...] = / del self.X[...] -> X."""
    if isinstance(target, ast.Subscript):
        return _mutated_attr(target.value)
    if (
        isinstance(target, ast.Attribute)
        and isinstance(target.value, ast.Name)
        and target.value.id == "self"
    ):
        return target.attr
    return None


def _receiver_attr(node) -> str | None:
    """self.X.append(...) / self.X[k].append(...) -> X."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _acquired_attrs(fn, lock_attrs) -> set:
    """Every class lock attr the method acquires anywhere in its body."""
    acquired = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            acquired |= _lock_items(node, lock_attrs)
    return acquired


def _acquires_lock(fn, lock_attrs) -> bool:
    return bool(_acquired_attrs(fn, lock_attrs))


def _locked_only_methods(cls, lock_attrs) -> set:
    """Methods every intra-class call site of which sits under the lock
    (directly, or inside another locked-only method) — the private-helper
    pattern (_maybe_finalize called from locked create/update/delete)."""
    methods = _methods(cls)
    # call sites: method -> [(callee, under_lock)]
    sites: dict = {m: [] for m in methods}
    for name, fn in methods.items():
        for node, held in _walk_with_lock(fn, lock_attrs):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"
                and node.func.attr in methods
            ):
                sites[name].append((node.func.attr, bool(held)))
    locked_only: set = set()
    changed = True
    while changed:
        changed = False
        for callee in methods:
            if callee in locked_only or callee == "__init__":
                continue
            callers = [
                (caller, under)
                for caller, calls in sites.items()
                for c, under in calls
                if c == callee
            ]
            if not callers:
                continue
            if all(
                under or caller in locked_only or _fully_locked(methods[caller], lock_attrs)
                for caller, under in callers
            ):
                locked_only.add(callee)
                changed = True
    return locked_only


def _fully_locked(fn, lock_attrs) -> bool:
    """The whole method body is one `with self._lock:` statement."""
    body = [s for s in fn.body if not _is_docstring(s)]
    return (
        len(body) == 1
        and isinstance(body[0], ast.With)
        and _lock_items(body[0], lock_attrs)
    )


def _is_docstring(stmt) -> bool:
    return isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant)


def _effective_lock_attrs(cls, class_map, _seen=None) -> dict:
    """Own lock attrs plus those inherited from bases resolvable in the
    project (Counter(_Metric) guards with the _Metric-assigned lock)."""
    _seen = _seen or set()
    if cls.name in _seen:
        return {}
    _seen.add(cls.name)
    attrs = dict(_lock_attrs(cls))
    for base in cls.bases:
        bname = dotted(base).split(".")[-1]
        entry = class_map.get(bname)
        if entry is not None:
            for k, v in _effective_lock_attrs(entry[1], class_map, _seen).items():
                attrs.setdefault(k, v)
    return attrs


def check_locks(project) -> list:
    findings: list = []
    class_map = {cls.name: (mod, cls) for mod, cls in project.classes()}
    # class name -> (module, ClassDef, lock_attrs) for typed composition edges
    lock_classes: dict = {}
    for mod, cls in project.classes():
        attrs = _effective_lock_attrs(cls, class_map)
        if attrs:
            lock_classes[cls.name] = (mod, cls, attrs)

    hold_edges: dict = {}  # class name -> set of class names acquired while held
    for cname, (mod, cls, lock_attrs) in lock_classes.items():
        methods = _methods(cls)

        # guarded attrs: lock IDENTITY matters — state guarded by self._a
        # is not protected by a method that only holds self._b. Each attr's
        # guard is the lock held at MOST of its locked mutation sites
        # (deterministic name tie-break), so a single wrong-lock site
        # cannot vote itself legitimate.
        lock_votes: dict = {}  # attr -> {lock: site count}
        for name, fn in methods.items():
            if name == "__init__":
                continue
            for attr, _line, held in _mutations(fn, lock_attrs):
                if held and attr not in lock_attrs:
                    votes = lock_votes.setdefault(attr, {})
                    for lock in held:
                        votes[lock] = votes.get(lock, 0) + 1
        guard_of = {
            attr: min(votes, key=lambda k: (-votes[k], k))
            for attr, votes in lock_votes.items()
        }

        locked_only = _locked_only_methods(cls, lock_attrs)

        # GL201: mutation of guarded state without holding its guard lock
        # (covers both the unlocked and the wrong-lock case)
        for name, fn in methods.items():
            if name == "__init__" or name in locked_only:
                continue
            for attr, line, held in _mutations(fn, lock_attrs):
                guard = guard_of.get(attr)
                if guard is not None and guard not in held:
                    findings.append(
                        Finding(
                            mod.path,
                            line,
                            "GL201",
                            f"{cname}.{name} mutates self.{attr} without "
                            f"holding self.{guard}, which guards it "
                            f"elsewhere in the class (lost-update race)",
                        )
                    )

        # GL203: re-entering a HELD plain Lock through a same-class method
        # call (direct recursion included — self.m() from inside m's own
        # locked region re-acquires just as fatally)
        plain = {a for a, kind in lock_attrs.items() if kind == "lock"}
        if plain:
            for name, fn in methods.items():
                for node, held in _walk_with_lock(fn, lock_attrs):
                    held_plain = held & plain
                    if not held_plain or not isinstance(node, ast.Call):
                        continue
                    if (
                        isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"
                        and node.func.attr in methods
                    ):
                        reentered = held_plain & _acquired_attrs(
                            methods[node.func.attr], plain
                        )
                        if reentered:
                            lock = "/".join(sorted(reentered))
                            findings.append(
                                Finding(
                                    mod.path,
                                    node.lineno,
                                    "GL203",
                                    f"{cname}.{name} holds non-reentrant "
                                    f"self.{lock} and calls "
                                    f"self.{node.func.attr}() which "
                                    f"re-acquires it — deadlock (use RLock "
                                    f"or an unlocked helper)",
                                )
                            )

        # holds-while-acquiring edges for GL202, via attributes typed by
        # construction (self.other = OtherClass(...) in __init__)
        attr_types: dict = {}
        init = methods.get("__init__")
        if init is not None:
            for node in ast.walk(init):
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                    callee = dotted(node.value.func).split(".")[-1]
                    if callee in lock_classes:
                        for t in node.targets:
                            attr = _mutated_attr(t)
                            if attr:
                                attr_types[attr] = callee
        for name, fn in methods.items():
            for node, held in _walk_with_lock(fn, lock_attrs):
                if not held or not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Attribute) and isinstance(
                    node.func.value, ast.Attribute
                ):
                    recv = node.func.value
                    if (
                        isinstance(recv.value, ast.Name)
                        and recv.value.id == "self"
                        and recv.attr in attr_types
                    ):
                        other = attr_types[recv.attr]
                        omod, ocls, oattrs = lock_classes[other]
                        ofn = _methods(ocls).get(node.func.attr)
                        if ofn is not None and _acquires_lock(ofn, oattrs):
                            hold_edges.setdefault(cname, {})[other] = (
                                mod.path,
                                node.lineno,
                            )

    # GL202: cycles in the holds-while-acquiring graph
    reported: set = set()
    for a, targets in hold_edges.items():
        for b, (path, line) in targets.items():
            if a == b:
                continue
            if a in hold_edges.get(b, {}) and frozenset((a, b)) not in reported:
                reported.add(frozenset((a, b)))
                findings.append(
                    Finding(
                        path,
                        line,
                        "GL202",
                        f"lock-order cycle: {a} acquires {b}'s lock while "
                        f"holding its own, and {b} does the reverse — "
                        f"ABBA deadlock under contention",
                    )
                )
    return findings
