"""lock-discipline: static lock-order graph + unlocked shared mutations.

Two rules over the whole analyzed tree:

* ``lock-order`` — build a static lock-acquisition graph.  Lock
  *classes* are (owning python class, attribute) pairs discovered from
  ``self.X = threading.Lock()/RLock()/Condition()`` assignments (plus
  module-level ``X = threading.Lock()``).  Within each method, ``with``
  items and ``.acquire()``/``.release()`` calls maintain a held set;
  acquiring B while holding A adds the edge A→B.  Calls to sibling
  methods propagate the callee's (transitively) acquired locks, so
  ``swap()`` holding ``_swap_lock`` and calling a helper that takes
  ``_lock`` contributes ``_swap_lock→_lock``.  A cycle in the edge
  graph is a potential AB/BA deadlock; a self-edge on a non-reentrant
  ``threading.Lock`` is a guaranteed one.

* ``unlocked-mutation`` — in any class that owns at least one lock,
  mutations of known shared-state attributes (``_delta_cache``, epoch/
  engine pointers, registry maps, pending buffers, caches) must happen
  while some lock is held.  Helper methods whose every intra-class call
  site holds a lock are clean; a lock-free call site (or a lock-free
  public mutation) is flagged.  Classes without locks are skipped —
  single-writer components (the store mutates only on the swap thread)
  are serialized by their OWNER's lock, which is exactly the convention
  this rule encodes.

Static and heuristic by design: the runtime companion
(``repro_torch.analysis.lockdep``) watches the orders that actually happen.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.base import (Finding, LintPass, ParsedFile,
                                 attr_chain)
from repro_torch.analysis.registry import register

#: attributes treated as shared mutable state when their class has a lock
WATCHED_SHARED = frozenset({
    "_delta_cache", "_engine", "_pending", "_queue", "_cache", "_full",
    "_families", "_children", "_w", "_segments", "_replicas",
    "_swap_listeners", "_node_ops_sum",
})

#: method calls that mutate their receiver in place
MUTATORS = frozenset({
    "append", "extend", "insert", "pop", "popitem", "clear", "update",
    "add", "remove", "discard", "setdefault", "move_to_end", "sort",
})

#: ctor-phase methods: the object is not yet shared
EXEMPT_METHODS = frozenset({"__init__", "__post_init__", "__new__"})

_LOCK_FACTORIES = {
    ("threading", "Lock"): "lock",
    ("threading", "RLock"): "rlock",
    ("threading", "Condition"): "rlock",   # RLock-backed by default
}


def _lock_kind(value: ast.AST) -> str | None:
    """'lock'/'rlock' when ``value`` is a threading lock constructor."""
    if not isinstance(value, ast.Call):
        return None
    return _LOCK_FACTORIES.get(attr_chain(value.func))


class _Mutation:
    __slots__ = ("attr", "line", "held")

    def __init__(self, attr: str, line: int, held: bool):
        self.attr, self.line, self.held = attr, line, held


class _Call:
    __slots__ = ("callee", "line", "held_keys")

    def __init__(self, callee: str, line: int, held_keys: tuple):
        self.callee, self.line, self.held_keys = callee, line, held_keys


class _Acquire:
    __slots__ = ("key", "line", "under")

    def __init__(self, key: str, line: int, under: tuple):
        self.key, self.line, self.under = key, line, under


class _MethodFacts:
    def __init__(self) -> None:
        self.acquires: list[_Acquire] = []
        self.calls: list[_Call] = []
        self.mutations: list[_Mutation] = []


class _ClassModel:
    def __init__(self, name: str, pf: ParsedFile):
        self.name = name
        self.pf = pf
        self.locks: dict[str, str] = {}           # attr -> kind
        self.methods: dict[str, _MethodFacts] = {}


class _MethodWalker:
    """Execution-ordered walk of one function body, tracking which lock
    keys are held (with-statements plus linear acquire/release)."""

    def __init__(self, model: _ClassModel, module_locks: dict[str, str],
                 facts: _MethodFacts):
        self.model = model
        self.module_locks = module_locks
        self.facts = facts
        self.held: list[str] = []

    # ------------------------------------------------------ lock keys

    def _key_of(self, expr: ast.AST) -> str | None:
        chain = attr_chain(expr)
        if len(chain) == 2 and chain[0] == "self" \
                and chain[1] in self.model.locks:
            return f"{self.model.name}.{chain[1]}"
        if len(chain) == 1 and chain[0] in self.module_locks:
            return f"<module>.{chain[0]}"
        return None

    def _kind_of(self, key: str) -> str:
        attr = key.split(".", 1)[1]
        if key.startswith("<module>."):
            return self.module_locks.get(attr, "lock")
        return self.model.locks.get(attr, "lock")

    def _acquire(self, key: str, line: int) -> None:
        self.facts.acquires.append(
            _Acquire(key, line, tuple(self.held)))
        self.held.append(key)

    # ----------------------------------------------------- statements

    def walk(self, stmts: list[ast.stmt]) -> None:
        for st in stmts:
            self._stmt(st)

    def _stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return                      # nested defs analyzed separately
        if isinstance(st, (ast.With, ast.AsyncWith)):
            entered: list[str] = []
            for item in st.items:
                self._expr(item.context_expr)
                key = self._key_of(item.context_expr)
                if key is not None:
                    self._acquire(key, item.context_expr.lineno)
                    entered.append(key)
            self.walk(st.body)
            for key in reversed(entered):
                if key in self.held:
                    self.held.remove(key)
            return
        if isinstance(st, (ast.If, ast.While)):
            self._expr(st.test)
            self.walk(st.body)
            self.walk(st.orelse)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(st.iter)
            self.walk(st.body)
            self.walk(st.orelse)
            return
        if isinstance(st, ast.Try):
            self.walk(st.body)
            for h in st.handlers:
                self.walk(h.body)
            self.walk(st.orelse)
            self.walk(st.finalbody)
            return
        if isinstance(st, ast.Match):
            self._expr(st.subject)
            for case in st.cases:
                self.walk(case.body)
            return
        # flat statement: mutations + calls inside, in one sweep
        self._flat(st)

    def _flat(self, st: ast.stmt) -> None:
        held = bool(self.held)
        for attr, line in _mutations_in(st):
            if attr in WATCHED_SHARED:
                self.facts.mutations.append(_Mutation(attr, line, held))
        self._expr(st)

    def _expr(self, node: ast.AST) -> None:
        """Scan an expression/statement subtree for calls: explicit
        acquire()/release(), and intra-class method calls."""
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            chain = attr_chain(sub.func)
            if len(chain) == 3 and chain[0] == "self" \
                    and chain[2] in ("acquire", "release") \
                    and chain[1] in self.model.locks:
                key = f"{self.model.name}.{chain[1]}"
                if chain[2] == "acquire":
                    self._acquire(key, sub.lineno)
                elif key in self.held:
                    self.held.remove(key)
                continue
            if len(chain) == 2 and chain[0] == "self" \
                    and chain[1] not in self.model.locks:
                self.facts.calls.append(
                    _Call(chain[1], sub.lineno, tuple(self.held)))


def _mutations_in(st: ast.stmt):
    """Yield (attr, line) for every self.<attr> mutation in a flat
    statement: assignment, aug-assign, subscript store, delete, and
    in-place mutator calls."""

    def _target_attrs(t: ast.AST):
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                yield from _target_attrs(el)
            return
        if isinstance(t, (ast.Subscript, ast.Starred)):
            yield from _target_attrs(t.value)
            return
        chain = attr_chain(t)
        if len(chain) == 2 and chain[0] == "self":
            yield chain[1], t.lineno

    if isinstance(st, ast.Assign):
        for t in st.targets:
            yield from _target_attrs(t)
    elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
        if not (isinstance(st, ast.AnnAssign) and st.value is None):
            yield from _target_attrs(st.target)
    elif isinstance(st, ast.Delete):
        for t in st.targets:
            yield from _target_attrs(t)
    for sub in ast.walk(st):
        if isinstance(sub, ast.Call):
            chain = attr_chain(sub.func)
            if len(chain) == 3 and chain[0] == "self" \
                    and chain[2] in MUTATORS:
                yield chain[1], sub.lineno


@register
class LockDisciplinePass(LintPass):
    name = "lock-discipline"
    description = ("static lock-order graph (AB/BA inversions, "
                   "self-deadlocks) + shared-state mutations outside "
                   "any lock in lock-owning classes")
    rules = ("lock-order", "unlocked-mutation")

    def run(self, files: list[ParsedFile]) -> list[Finding]:
        models: list[_ClassModel] = []
        for pf in files:
            models.extend(self._collect(pf))
        out: list[Finding] = []
        out.extend(self._check_order(models))
        for model in models:
            out.extend(self._check_mutations(model))
        return out

    # ------------------------------------------------------- collection

    def _collect(self, pf: ParsedFile) -> list[_ClassModel]:
        module_locks: dict[str, str] = {}
        for st in pf.tree.body:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                kind = _lock_kind(st.value)
                if kind:
                    module_locks[st.targets[0].id] = kind
        models = []
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            model = _ClassModel(node.name, pf)
            methods = [m for m in node.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            # sweep 1: lock attribute discovery (any method, any depth)
            for m in methods:
                for sub in ast.walk(m):
                    value = None
                    target = None
                    if isinstance(sub, ast.Assign) \
                            and len(sub.targets) == 1:
                        target, value = sub.targets[0], sub.value
                    elif isinstance(sub, ast.AnnAssign):
                        target, value = sub.target, sub.value
                    if value is None:
                        continue
                    kind = _lock_kind(value)
                    chain = attr_chain(target)
                    if kind and len(chain) == 2 and chain[0] == "self":
                        model.locks[chain[1]] = kind
            # sweep 2: per-method facts
            for m in methods:
                facts = _MethodFacts()
                walker = _MethodWalker(model, module_locks, facts)
                walker.walk(m.body)
                model.methods[m.name] = facts
            models.append(model)
        return models

    # ------------------------------------------------------- lock order

    def _check_order(self, models: list[_ClassModel]) -> list[Finding]:
        # transitive closure of per-method acquired locks via self-calls
        closure: dict[tuple[str, str], set[str]] = {}
        for model in models:
            for mname, facts in model.methods.items():
                closure[(model.name, mname)] = {
                    a.key for a in facts.acquires}
        changed = True
        while changed:
            changed = False
            for model in models:
                for mname, facts in model.methods.items():
                    mine = closure[(model.name, mname)]
                    for call in facts.calls:
                        callee = closure.get((model.name, call.callee))
                        if callee and not callee <= mine:
                            mine |= callee
                            changed = True

        edges: dict[str, dict[str, tuple[ParsedFile, int]]] = {}
        kinds: dict[str, str] = {}

        def _edge(a: str, b: str, pf: ParsedFile, line: int) -> None:
            edges.setdefault(a, {}).setdefault(b, (pf, line))
            edges.setdefault(b, {})

        for model in models:
            for attr, kind in model.locks.items():
                kinds[f"{model.name}.{attr}"] = kind
            for facts in model.methods.values():
                for acq in facts.acquires:
                    for held in acq.under:
                        _edge(held, acq.key, model.pf, acq.line)
                for call in facts.calls:
                    for lk in closure.get((model.name, call.callee), ()):
                        for held in call.held_keys:
                            # held == lk is a re-entry self-edge; the
                            # self-edge check below flags it only for
                            # non-reentrant Lock kinds
                            _edge(held, lk, model.pf, call.line)

        out: list[Finding] = []
        # self-edges on non-reentrant locks: guaranteed self-deadlock
        for a, succ in edges.items():
            if a in succ and kinds.get(a, "lock") == "lock":
                pf, line = succ[a]
                out.append(self.finding(
                    "lock-order", pf, line,
                    f"nested acquisition of non-reentrant lock {a} "
                    "(self-deadlock; use an RLock or restructure)"))
        # cycles across distinct locks: potential AB/BA inversion
        for cyc in _cycles(edges):
            members = set(cyc)
            wits = []
            anchor: tuple[ParsedFile, int] | None = None
            for a in cyc:
                for b, (pf, line) in sorted(edges[a].items()):
                    if b in members and b != a:
                        wits.append(
                            f"{a}->{b} at {pf.module_key()}:{line}")
                        if anchor is None:
                            anchor = (pf, line)
            if anchor is None:
                continue
            out.append(self.finding(
                "lock-order", anchor[0], anchor[1],
                "potential lock-order inversion between "
                + ", ".join(cyc) + ": " + " ; ".join(wits)))
        return out

    # ------------------------------------------- unlocked shared state

    def _check_mutations(self, model: _ClassModel) -> list[Finding]:
        if not model.locks:
            return []
        out: list[Finding] = []
        locks_txt = ", ".join(sorted(model.locks))
        dirty: dict[str, list[_Mutation]] = {}
        for mname, facts in model.methods.items():
            if mname in EXEMPT_METHODS:
                continue
            unlocked = [mu for mu in facts.mutations if not mu.held]
            if unlocked:
                dirty[mname] = unlocked
        for mname, muts in dirty.items():
            # every intra-class call site holding a lock launders the
            # helper clean; a lock-free call site is the finding
            sites = [(caller, c) for caller, f in model.methods.items()
                     for c in f.calls if c.callee == mname]
            if sites and all(c.held_keys for _, c in sites):
                continue
            bad_sites = [(caller, c) for caller, c in sites
                         if not c.held_keys]
            if bad_sites and mname.startswith("_"):
                for caller, c in bad_sites:
                    attrs = ", ".join(sorted({mu.attr for mu in muts}))
                    out.append(self.finding(
                        "unlocked-mutation", model.pf, c.line,
                        f"{model.name}.{caller} calls {mname}() which "
                        f"mutates shared {attrs!r} without holding any "
                        f"of this class's locks ({locks_txt})"))
                continue
            for mu in muts:
                out.append(self.finding(
                    "unlocked-mutation", model.pf, mu.line,
                    f"{model.name}.{mname} mutates shared "
                    f"{mu.attr!r} outside any lock (class owns "
                    f"{locks_txt})"))
        return out


def _cycles(edges: dict[str, dict[str, tuple]]) -> list[list[str]]:
    """Distinct simple cycles (as SCC member lists, length ≥ 2)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    counter = [0]
    sccs: list[list[str]] = []

    def strongconnect(v: str) -> None:
        # iterative Tarjan
        work = [(v, iter(edges.get(v, ())))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(edges.get(w, ()))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))

    for v in sorted(edges):
        if v not in index:
            strongconnect(v)
    return sccs
