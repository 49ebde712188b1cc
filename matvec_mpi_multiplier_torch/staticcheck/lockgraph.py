"""Lock-graph concurrency auditor: whole-program lock analysis.

The port's counterpart of the JAX package's ``staticcheck/lockgraph.py``,
the same walker over the port's tree. The serving engine is a concurrent
system — the engine's ``_swap_lock`` and residency and breaker locks, the
registry's locks, the scheduler's conditions and the metrics' mutexes
across ``engine/``, ``obs/`` and ``resilience/`` — and the races the JAX
package's reviews caught by hand (a phantom HBM ledger charge, a quota
overrun, ``health()`` racing ``_walk_ladder``) have the same shapes here.
The line-level rules (#8, #11) pin *what may not happen under a lock*; this
module analyzes *how the locks compose*, whole-program, as rules
#13–#15 in the ordinary registry (markers, fixtures and CLI plumbing
inherit):

* **#13 ``lock-mixed-guard``** (marker ``unguarded-ok``) — per-class
  guard-set inference: a ``self._*`` attribute written under a
  ``with self._lock``-style context somewhere but read (or written)
  with no lock held elsewhere is a torn/stale-state hazard. The repo's
  ``*_locked``-suffix helper convention (``_take_locked``,
  ``_evict_for_locked`` — "caller holds the lock") is built in: their
  bodies count as guarded, and *calling* a ``*_locked`` helper with no
  lock held is itself a finding.
* **#14 ``lock-order-inversion``** (marker ``lock-order-ok``) — the
  cross-class lock-acquisition order graph: an edge A→B is recorded
  whenever code acquires B while holding A, directly or through a
  method call (resolved via ``self`` methods, constructor-annotated
  attribute types, and name-based fallback over the corpus — the alias
  discipline ``corpus.py`` established for imports, extended to
  methods). A cycle means two threads can take the same locks in
  opposite orders and deadlock; the audit fails on any cycle. A marker
  on an edge's acquisition/call site removes that edge.
* **#15 ``callback-under-lock``** (marker ``callback-ok``) — invoking a
  callback/listener (``*listener*``/``*callback*``/``*hook*``/
  ``on_*``-named callables, directly or transitively through resolved
  method calls) while holding a lock runs UNKNOWN code under a held
  mutex — the exact shape of the JAX package's ledger bug, where the engine's
  residency listener fired under the residency bookkeeping lock and
  re-entered the registry. Deliberate, documented exceptions (the
  registry's reentrant victim-release path) carry the marker.

Scope: ``engine/``, ``obs/``, ``resilience/`` and ``tuning/`` — the
subsystems with locks (tuning rides along so a future cache mutex is
covered the day it appears). Pure AST work: this module imports neither
torch nor anything that initializes a device.

The analysis is whole-program (the graph spans files), while the rule
engine is per-file: ``analyze(root)`` builds one :class:`LockGraph` per
corpus (cached, keyed by file content) and each rule's per-file check
reads its slice of the findings out of it.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
from pathlib import Path
from typing import Iterator

from .corpus import SourceFile, iter_corpus, source_file

_PKG = "matvec_mpi_multiplier_torch"

# The concurrent subsystems the auditor covers.
SCOPE_DIRS = ("engine", "obs", "resilience", "tuning")

LOCKGRAPH_RULES = (
    "lock-mixed-guard", "lock-order-inversion", "callback-under-lock",
)

# Context-manager / attribute name fragments that mark a lock (same
# vocabulary as rules #8/#11).
_LOCKISH = ("lock", "cond", "mutex")
# Callee-name fragments that mark a callback (the listener/hook surface
# the engine, registry and breakers expose).
_CALLBACK_FRAGMENTS = ("listener", "callback", "hook")
_LOCKED_SUFFIX = "_locked"

# Receiver-mutating method names: `self._pending.append(x)` is a WRITE
# to self._pending for guard purposes, not a read of the binding.
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "update", "remove",
    "discard", "pop", "popleft", "popitem", "clear", "setdefault",
})

# Guard token for `*_locked` helper bodies: "guarded by whatever lock the
# caller holds" — compatible with every own lock in the guard check,
# invisible to the order graph (which uses the real own-lock ids).
_ANY = ("<caller>", "<locked-helper>")

_LOCK_FACTORIES = ("threading.Lock", "threading.RLock", "threading.Condition")


def lockgraph_scope(rel: str) -> bool:
    return any(rel.startswith(f"{_PKG}/{d}/") for d in SCOPE_DIRS)


def _is_lockish(name: str) -> bool:
    return any(f in name.lower() for f in _LOCKISH)


def _is_callbackish(name: str) -> bool:
    n = name.lower()
    return (
        any(f in n for f in _CALLBACK_FRAGMENTS)
        or n.startswith("on_")
        or n.startswith("_on_")
    )


def _fmt_lock(lock: tuple[str, str]) -> str:
    return f"{lock[0]}.{lock[1]}"


# --------------------------------------------------------- per-file model


@dataclasses.dataclass
class _Access:
    attr: str
    kind: str               # "read" | "write"
    held: frozenset         # lock ids (incl. _ANY in *_locked helpers)
    node: ast.AST


@dataclasses.dataclass
class _CallSite:
    target: tuple           # ("self", name) | ("attr", base, name) | ("name", name)
    held: frozenset
    node: ast.AST


@dataclasses.dataclass
class _Acquire:
    lock: tuple[str, str]   # lock id (owner, attr)
    held: frozenset
    node: ast.AST


class _Method:
    __slots__ = (
        "cls", "name", "sf", "node", "accesses", "calls", "acquires",
        "is_locked_helper", "is_init",
    )

    def __init__(self, cls: "_Class | None", name: str, sf: SourceFile,
                 node: ast.AST):
        self.cls = cls
        self.name = name
        self.sf = sf
        self.node = node
        self.accesses: list[_Access] = []
        self.calls: list[_CallSite] = []
        self.acquires: list[_Acquire] = []
        self.is_locked_helper = name.endswith(_LOCKED_SUFFIX)
        self.is_init = name == "__init__"


class _Class:
    __slots__ = ("name", "sf", "methods", "own_locks", "attr_types")

    def __init__(self, name: str, sf: SourceFile):
        self.name = name
        self.sf = sf
        self.methods: dict[str, _Method] = {}
        self.own_locks: set[str] = set()      # lockish self attrs
        self.attr_types: dict[str, str] = {}  # self attr -> annotated class


def _ann_name(ann: ast.AST | None) -> str | None:
    """The terminal class name of a parameter annotation (string
    annotations unquoted, `a.b.C` -> `C`, Optional-ish wrappers ignored)."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.strip("'\"").split(".")[-1].split("[")[0].strip()
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Attribute):
        return ann.attr
    return None


def _self_chain(expr: ast.AST) -> list[str] | None:
    """`self.a.b` -> ["self", "a", "b"]; None for non-self-rooted chains."""
    parts: list[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self":
        parts.append("self")
        return list(reversed(parts))
    return None


class _MethodWalker:
    """One method body, walked with the held-lock set threaded through:
    records attribute accesses, lock acquisitions and call sites.
    Deferred bodies (nested def/lambda) are skipped — they run under
    whatever lock state exists at call time, not this one."""

    def __init__(self, sf: SourceFile, cls: _Class | None, meth: _Method):
        self.sf = sf
        self.cls = cls
        self.meth = meth

    def run(self) -> None:
        held: frozenset = frozenset()
        if self.meth.is_locked_helper and self.cls is not None:
            held = frozenset(
                {(self.cls.name, lk) for lk in self.cls.own_locks}
            ) | {_ANY}
        body = getattr(self.meth.node, "body", [])
        for stmt in body:
            self._visit(stmt, held)

    # ---- lock identification ----

    def _lock_of(self, expr: ast.AST) -> tuple[str, str] | None:
        """The lock a with-item acquires, as an (owner, attr) id — or
        None for a non-lockish context manager (a trace span)."""
        ctx = self.cls.name if self.cls is not None else f"<{self.sf.rel}>"
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Attribute) and _is_lockish(sub.attr):
                chain = _self_chain(sub)
                if chain is None:
                    # with eng._b_lock: — a lock reached through a local
                    # or parameter. Owner unknown here; a context-scoped
                    # placeholder that _normalize_locks unifies by unique
                    # lock-attr name across the corpus (so a direct AB/BA
                    # through a local is still a cycle).
                    root = sub.value
                    base = root.id if isinstance(root, ast.Name) else "expr"
                    return (f"?{ctx}.{base}", sub.attr)
                if len(chain) == 2 and self.cls is not None:
                    # with self._lock:
                    return (self.cls.name, chain[1])
                if len(chain) == 3 and self.cls is not None:
                    # with self.registry._lock: — owner via the annotated
                    # attribute type when known; otherwise a placeholder
                    # scoped to THIS class+attr (so unrelated classes'
                    # `?engine` never collide into phantom edges) that
                    # LockGraph._normalize_locks unifies by unique lock
                    # attr name across the corpus.
                    owner = self.cls.attr_types.get(
                        chain[1], f"?{self.cls.name}.{chain[1]}"
                    )
                    return (owner, chain[2])
            elif isinstance(sub, ast.Name) and _is_lockish(sub.id):
                # with _default_lock: (a module-level mutex)
                owner = (
                    self.cls.name if self.cls is not None
                    else f"<{self.sf.rel}>"
                )
                return (owner, sub.id)
        return None

    # ---- the walk ----

    def _visit(self, node: ast.AST, held: frozenset) -> None:
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            return  # deferred body
        if isinstance(node, (ast.With, ast.AsyncWith)):
            # Items acquire left-to-right: `with self._a, self._b:` holds
            # _a while acquiring _b, so each item's acquisition event
            # carries the locks the EARLIER items already took (the
            # AB/BA inversion the order graph exists to catch).
            cur = held
            for item in node.items:
                self._visit(item.context_expr, cur)
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    # Anchored to the context EXPRESSION (one line), not
                    # the With node — a With spans its whole body, and a
                    # marker deep inside the block must not exempt the
                    # acquisition edge recorded at its head.
                    self.meth.acquires.append(
                        _Acquire(lock, cur, item.context_expr)
                    )
                    cur = cur | {lock}
            for stmt in node.body:
                self._visit(stmt, cur)
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, held)
            return
        if isinstance(node, ast.Subscript) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            # self.charged[k] = v — a write to self.charged.
            chain = _self_chain(node.value)
            if chain is not None and len(chain) == 2:
                self._access(chain[1], "write", held, node)
                self._visit(node.slice, held)
                return
        if isinstance(node, ast.Attribute):
            chain = _self_chain(node)
            if chain is not None and len(chain) == 2:
                kind = (
                    "write" if isinstance(node.ctx, (ast.Store, ast.Del))
                    else "read"
                )
                self._access(chain[1], kind, held, node)
                return
            # fall through: visit the base (self.engine.submit reads
            # self.engine on the way down)
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)

    def _access(self, attr: str, kind: str, held: frozenset,
                node: ast.AST) -> None:
        self.meth.accesses.append(_Access(attr, kind, held, node))

    def _visit_call(self, call: ast.Call, held: frozenset) -> None:
        fn = call.func
        target = None
        if isinstance(fn, ast.Attribute):
            chain = _self_chain(fn)
            if chain is not None and len(chain) == 2:
                # self.method(...) / self._listener(...). Invoking IS
                # reading the attribute: a callable attr written under a
                # lock and called bare must register as a bare read
                # (class methods are never written attrs, so this is
                # noise-free for ordinary method calls).
                target = ("self", chain[1])
                self._access(chain[1], "read", held, fn)
            elif chain is not None and len(chain) == 3:
                # self.registry.prefetch(...)
                target = ("attr", chain[1], chain[2])
                self._access(chain[1], "read", held, fn.value)
            else:
                # entry.engine.submit(...) — name-based fallback
                target = ("name", fn.attr)
                self._visit(fn.value, held)
            # receiver-mutating method on a self attribute is a write
            if (
                chain is not None and len(chain) == 3
                and fn.attr in _MUTATORS
            ):
                # self._pending.append(...): rewrite the read recorded
                # above into a write (last recorded access is the base).
                self.meth.accesses[-1] = _Access(
                    chain[1], "write", held, fn.value
                )
        elif isinstance(fn, ast.Name):
            target = ("name", fn.id)
        else:
            self._visit(fn, held)
        if target is not None:
            self.meth.calls.append(_CallSite(target, held, call))
        for arg in call.args:
            self._visit(arg, held)
        for kw in call.keywords:
            self._visit(kw.value, held)


# ------------------------------------------------------- the whole program


class LockGraph:
    """One corpus's lock analysis: classes, methods, the acquisition
    graph, and the per-rule findings, keyed by repo-relative path."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.classes: dict[str, _Class] = {}
        self.module_funcs: dict[str, list[_Method]] = {}
        self.methods_by_name: dict[str, list[_Method]] = {}
        self.all_methods: list[_Method] = []
        # rule -> rel -> [(node, message)]
        self.findings: dict[str, dict[str, list[tuple[ast.AST, str]]]] = {
            rule: {} for rule in LOCKGRAPH_RULES
        }
        # rel -> line spans where a '# lock-order-ok:' marker actually
        # DROPPED an edge. This rule consumes its marker before cycle
        # detection (an exempted edge suppresses the whole cycle, so no
        # raw finding ever surfaces at the marked site — or at its
        # sibling edges); the stale-marker audit must take these spans
        # as live coverage or every working exemption looks rotted.
        self.marker_hits: dict[str, set[int]] = {}
        self._build()
        self._normalize_locks()
        self._refine_locked_helpers()
        self._infer_guards()
        self._build_graph()
        self._check_callbacks()

    # ---- corpus ingestion ----

    def _build(self) -> None:
        for path in iter_corpus(self.root):
            rel = path.relative_to(self.root).as_posix()
            if not lockgraph_scope(rel):
                continue
            try:
                sf = source_file(path, self.root)
            except (SyntaxError, UnicodeDecodeError):
                continue  # run_rules owns the parse-error finding
            for node in sf.nodes(ast.ClassDef):
                self._ingest_class(sf, node)
            for node in sf.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    meth = _Method(None, node.name, sf, node)
                    _MethodWalker(sf, None, meth).run()
                    self.module_funcs.setdefault(node.name, []).append(meth)
                    self.all_methods.append(meth)

    def _ingest_class(self, sf: SourceFile, node: ast.ClassDef) -> None:
        cls = _Class(node.name, sf)
        methods = [
            n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        # Pass 1: own locks (lockish self attrs assigned a threading
        # factory, or entered as a context) and annotated attr types.
        for m in methods:
            params = {
                a.arg: _ann_name(a.annotation) for a in m.args.args
            }
            for sub in ast.walk(m):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    chain = _self_chain(sub.targets[0])
                    if chain is None or len(chain) != 2:
                        continue
                    attr = chain[1]
                    q = (
                        sf.qualname(sub.value.func)
                        if isinstance(sub.value, ast.Call) else None
                    )
                    if q in _LOCK_FACTORIES and _is_lockish(attr):
                        cls.own_locks.add(attr)
                    if m.name == "__init__" and isinstance(
                        sub.value, ast.Name
                    ):
                        ann = params.get(sub.value.id)
                        if ann:
                            cls.attr_types[attr] = ann
                elif isinstance(sub, (ast.With, ast.AsyncWith)):
                    for item in sub.items:
                        for inner in ast.walk(item.context_expr):
                            chain = (
                                _self_chain(inner)
                                if isinstance(inner, ast.Attribute) else None
                            )
                            if (
                                chain is not None and len(chain) == 2
                                and _is_lockish(chain[1])
                            ):
                                cls.own_locks.add(chain[1])
        # Pass 2: walk bodies with the held-lock context.
        for m in methods:
            meth = _Method(cls, m.name, sf, m)
            _MethodWalker(sf, cls, meth).run()
            cls.methods[m.name] = meth
            self.methods_by_name.setdefault(m.name, []).append(meth)
            self.all_methods.append(meth)
        self.classes[cls.name] = cls

    # ---- lock-id normalization ----

    def _normalize_locks(self) -> None:
        """Unify unresolved foreign-lock placeholders (`with
        self.other._residency_lock:` where ``other`` carries no type
        annotation) with the class that owns a lock of that attr name —
        when exactly ONE class in the corpus does. Without this, a
        direct AB/BA acquisition through an unannotated attribute would
        produce two never-unifying nodes and the cycle would be
        invisible; with a non-unique attr name (every metrics class
        calls its mutex ``_lock``) the placeholder is kept — ambiguity
        must not fabricate phantom edges."""
        owners: dict[str, list[str]] = {}
        for cls in self.classes.values():
            for lk in cls.own_locks:
                owners.setdefault(lk, []).append(cls.name)

        def norm(lock):
            if lock == _ANY or not lock[0].startswith("?"):
                return lock
            unique = owners.get(lock[1], [])
            return (unique[0], lock[1]) if len(unique) == 1 else lock

        for m in self.all_methods:
            for a in m.acquires:
                a.lock = norm(a.lock)
                a.held = frozenset(norm(lk) for lk in a.held)
            for acc in m.accesses:
                acc.held = frozenset(norm(lk) for lk in acc.held)
            for call in m.calls:
                call.held = frozenset(norm(lk) for lk in call.held)

    def _refine_locked_helpers(self) -> None:
        """Tighten the ``*_locked`` helpers' assumed held set from "all
        of the class's own locks" to the union of what their callers
        ACTUALLY hold at the call sites. On a one-lock class the two are
        identical; on a multi-lock class the conservative assumption
        fabricates edges from locks no execution path holds — a phantom
        deadlock cycle the author would have to mark away. Helpers with
        no observed lock-holding caller keep the conservative set (a
        helper exercised only from fixtures must not silently lose its
        guard semantics)."""
        for cls in self.classes.values():
            if not cls.own_locks:
                continue
            assumed = frozenset(
                (cls.name, lk) for lk in cls.own_locks
            ) | {_ANY}
            for helper in cls.methods.values():
                if not helper.is_locked_helper:
                    continue
                callers_held: set = set()
                for caller in cls.methods.values():
                    for call in caller.calls:
                        if (
                            call.target == ("self", helper.name)
                            and call.held
                        ):
                            callers_held |= {
                                lk for lk in call.held if lk != _ANY
                            }
                if not callers_held:
                    continue
                actual = frozenset(callers_held) | {_ANY}

                def swap(held):
                    # Inside the helper every event's held set contains
                    # the symbolic assumption (plus any locks the body
                    # acquired on top — those survive the swap).
                    return (held - assumed) | actual if _ANY in held \
                        else held

                for a in helper.acquires:
                    a.held = swap(a.held)
                for acc in helper.accesses:
                    acc.held = swap(acc.held)
                for call in helper.calls:
                    call.held = swap(call.held)

    # ---- resolution ----

    def _resolve(self, meth: _Method, target: tuple) -> list[_Method]:
        """Call targets a site may reach: `self` methods exactly, typed
        attributes exactly, then the name-based corpus fallback."""
        kind = target[0]
        if kind == "self" and meth.cls is not None:
            own = meth.cls.methods.get(target[1])
            if own is not None:
                return [own]
            return self._by_name(target[1])
        if kind == "attr" and meth.cls is not None:
            base, name = target[1], target[2]
            tname = meth.cls.attr_types.get(base)
            if tname is not None and tname in self.classes:
                m = self.classes[tname].methods.get(name)
                return [m] if m is not None else []
            return self._by_name(name)
        return self._by_name(target[-1])

    def _by_name(self, name: str) -> list[_Method]:
        if name in self.classes:
            init = self.classes[name].methods.get("__init__")
            return [init] if init is not None else []
        return list(self.methods_by_name.get(name, [])) + list(
            self.module_funcs.get(name, [])
        )

    def _add(self, rule: str, sf: SourceFile, node: ast.AST,
             message: str) -> None:
        self.findings[rule].setdefault(sf.rel, []).append((node, message))

    # ---- rule #13: guard-set inference ----

    def _infer_guards(self) -> None:
        for cls in self.classes.values():
            if not cls.own_locks:
                continue
            writes: dict[str, set] = {}
            write_site: dict[str, ast.AST] = {}
            for meth in cls.methods.values():
                if meth.is_init:
                    continue
                for acc in meth.accesses:
                    if acc.kind == "write" and acc.held:
                        writes.setdefault(acc.attr, set()).update(acc.held)
                        write_site.setdefault(acc.attr, acc.node)
            for meth in cls.methods.values():
                if meth.is_init:
                    continue
                for acc in meth.accesses:
                    locks = writes.get(acc.attr)
                    if locks is None or _is_lockish(acc.attr):
                        continue
                    if self._guarded(acc.held, locks):
                        continue
                    site = write_site[acc.attr]
                    named = sorted(
                        _fmt_lock(lk) for lk in locks if lk != _ANY
                    ) or ["the caller-held lock"]
                    held_names = sorted(
                        _fmt_lock(lk) for lk in acc.held if lk != _ANY
                    )
                    how = (
                        "with no lock held" if not held_names else
                        f"holding only {', '.join(held_names)} — not a "
                        "lock it is written under"
                    )
                    self._add(
                        "lock-mixed-guard", cls.sf, acc.node,
                        f"self.{acc.attr} is written under "
                        f"{', '.join(named)} (e.g. line "
                        f"{getattr(site, 'lineno', '?')}) but "
                        f"{'written' if acc.kind == 'write' else 'read'} "
                        f"here {how} — a concurrent writer can "
                        "tear or stale this access (guard it, or mark a "
                        "deliberate racy read with '# unguarded-ok: "
                        "<reason>')",
                    )
                # Calling a *_locked helper with no lock held breaks the
                # convention the helper's name promises.
                for call in meth.calls:
                    if (
                        call.target[0] == "self"
                        and call.target[1].endswith(_LOCKED_SUFFIX)
                        and not call.held
                        and not meth.is_locked_helper
                    ):
                        self._add(
                            "lock-mixed-guard", cls.sf, call.node,
                            f"{call.target[1]}() is a *_locked helper "
                            "(caller-holds-the-lock convention) invoked "
                            "with no lock held",
                        )

    @staticmethod
    def _guarded(held: frozenset, write_locks: set) -> bool:
        """An access is guarded when it holds one of the locks the
        attribute is written under. ``_ANY`` appears in ``held`` only
        inside a ``*_locked`` helper (guarded by the caller's lock, by
        convention); it is deliberately NOT honored on the write side —
        helper-body writes also stamp the class's real own locks, so a
        read under a *different* object's lock must still miss the
        intersection and be flagged (the wrong-lock case)."""
        if not held:
            return False
        if _ANY in held:
            return True
        return bool((held & write_locks) - {_ANY})

    # ---- rule #14: the acquisition-order graph ----

    def _acquires_transitive(self) -> dict[int, frozenset]:
        """Fixpoint: every lock a method may acquire during its
        execution, directly or through resolved calls."""
        acq: dict[int, set] = {
            id(m): {a.lock for a in m.acquires} for m in self.all_methods
        }
        targets: dict[int, list[_Method]] = {}
        for m in self.all_methods:
            outs: list[_Method] = []
            for call in m.calls:
                outs.extend(self._resolve(m, call.target))
            targets[id(m)] = outs
        changed = True
        while changed:
            changed = False
            for m in self.all_methods:
                cur = acq[id(m)]
                for t in targets[id(m)]:
                    extra = acq[id(t)] - cur
                    if extra:
                        cur |= extra
                        changed = True
        return {k: frozenset(v) for k, v in acq.items()}

    def _build_graph(self) -> None:
        acq = self._acquires_transitive()
        # edge (held, acquired) -> [(sf, node, via)]
        edges: dict[tuple, list] = {}

        def add_edge(h, lk, sf, node, via):
            if h == lk or h == _ANY or lk == _ANY:
                return
            if "lock-order-ok:" in sf.span_comments(node):
                # Marker drops the edge before cycle detection; record
                # the consumed span so the stale audit sees it as live.
                first = getattr(node, "lineno", 0)
                last = getattr(node, "end_lineno", first) or first
                self.marker_hits.setdefault(sf.rel, set()).update(
                    range(first, last + 1)
                )
                return
            edges.setdefault((h, lk), []).append((sf, node, via))

        for m in self.all_methods:
            for a in m.acquires:
                for h in a.held:
                    add_edge(h, a.lock, m.sf, a.node, "direct acquisition")
            for call in m.calls:
                if not call.held:
                    continue
                for t in self._resolve(m, call.target):
                    for lk in acq[id(t)]:
                        for h in call.held:
                            add_edge(
                                h, lk, m.sf, call.node,
                                f"call to {call.target[-1]}()",
                            )
        self.edges = edges
        # Cycle detection over the lock digraph.
        graph: dict[tuple, set] = {}
        for (h, lk) in edges:
            graph.setdefault(h, set()).add(lk)
        for cycle in _find_cycles(graph):
            path = " -> ".join(_fmt_lock(lk) for lk in cycle)
            pairs = list(zip(cycle, cycle[1:]))
            for pair in pairs:
                for sf, node, via in edges.get(pair, []):
                    self._add(
                        "lock-order-inversion", sf, node,
                        f"acquiring {_fmt_lock(pair[1])} while holding "
                        f"{_fmt_lock(pair[0])} ({via}) closes the lock "
                        f"cycle {path} — two threads taking these locks "
                        "in opposite orders deadlock; release before "
                        "acquiring, or mark a proven-safe edge with "
                        "'# lock-order-ok: <reason>'",
                    )

    # ---- rule #15: callbacks under a lock ----

    def _check_callbacks(self) -> None:
        # Fixpoint: does a method invoke a callback (directly, or through
        # self/typed-attr/name-resolved calls)? Direct invocation =
        # calling a callbackish NAME.
        invokes: dict[int, str | None] = {}
        for m in self.all_methods:
            direct = None
            for call in m.calls:
                if _is_callbackish(call.target[-1]):
                    direct = call.target[-1]
                    break
            invokes[id(m)] = direct
        changed = True
        while changed:
            changed = False
            for m in self.all_methods:
                if invokes[id(m)]:
                    continue
                for call in m.calls:
                    for t in self._resolve(m, call.target):
                        via = invokes[id(t)]
                        if via:
                            invokes[id(m)] = via
                            changed = True
                            break
                    if invokes[id(m)]:
                        break

        for m in self.all_methods:
            for call in m.calls:
                if not call.held:
                    continue
                name = call.target[-1]
                held = sorted(
                    _fmt_lock(lk) for lk in call.held if lk != _ANY
                ) or ["the caller-held lock"]
                if _is_callbackish(name):
                    self._add(
                        "callback-under-lock", m.sf, call.node,
                        f"{name}() invoked while holding "
                        f"{', '.join(held)}: a callback is unknown code "
                        "under a held mutex (the ledger-bug shape) — "
                        "invoke it after release, or mark a documented "
                        "exception with '# callback-ok: <reason>'",
                    )
                    continue
                # Transitive: suppressed when the target is a *_locked
                # helper of the same class — its own (caller-held) direct
                # site already carries the finding/marker.
                if (
                    call.target[0] == "self"
                    and name.endswith(_LOCKED_SUFFIX)
                ):
                    continue
                for t in self._resolve(m, call.target):
                    via = invokes[id(t)]
                    if via:
                        self._add(
                            "callback-under-lock", m.sf, call.node,
                            f"{name}() invokes the {via} callback while "
                            f"{', '.join(held)} is held (the "
                            "ledger-bug shape) — restructure to fire "
                            "after release, or mark a documented "
                            "exception with '# callback-ok: <reason>'",
                        )
                        break


def _find_cycles(graph: dict) -> list[list]:
    """Cycles in the lock digraph, one representative per cyclic SCC
    (Tarjan would be overkill at this node count): DFS from each node,
    reporting the first closed walk found back to it."""
    cycles = []
    seen_cycles = set()
    for start in sorted(graph):
        stack = [(start, [start])]
        visited = set()
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    cycle = path + [start]
                    key = frozenset(cycle)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        cycles.append(cycle)
                elif nxt not in visited:
                    visited.add(nxt)
                    stack.append((nxt, path + [nxt]))
    return cycles


# ----------------------------------------------------------- cache + rules


# root -> (generation, content signature, graph). The content signature
# (per-file sha1) decides whether to rebuild; the generation decides
# whether to even RE-READ the corpus — run_rules bumps it once per
# invocation, so the 3 rules' per-file checks share one validation pass
# instead of re-hashing the corpus O(files x rules) times.
_CACHE: dict[str, tuple[int, tuple, LockGraph]] = {}
_GENERATION = [0]


def new_generation() -> None:
    """Invalidate the once-per-run corpus validation (rules.run_rules
    calls this at entry; a direct ``analyze`` caller that mutates files
    between calls must call it too)."""
    _GENERATION[0] += 1


def analyze(root: Path) -> LockGraph:
    """The corpus's lock graph, rebuilt only when an in-scope file's
    content changes, and validated at most once per rule-engine run
    (the rule engine calls per file; the analysis is whole-program)."""
    root = Path(root)
    key = str(root.resolve())
    gen = _GENERATION[0]
    cached = _CACHE.get(key)
    if cached is not None and cached[0] == gen:
        return cached[2]
    sig = []
    for path in iter_corpus(root):
        rel = path.relative_to(root).as_posix()
        if lockgraph_scope(rel):
            sig.append(
                (rel, hashlib.sha1(path.read_bytes()).hexdigest())
            )
    sig_t = tuple(sig)
    if cached is not None and cached[1] == sig_t:
        graph = cached[2]
    else:
        graph = LockGraph(root)
    _CACHE[key] = (gen, sig_t, graph)
    return graph


def _check_for(rule: str):
    def check(sf: SourceFile) -> Iterator[tuple[ast.AST, str]]:
        yield from analyze(sf.root).findings[rule].get(sf.rel, [])

    return check


def register_lockgraph_rules(register) -> None:
    """Hook the three lock-graph rules into the ordinary rule registry
    (rules.py calls this before computing MARKERS)."""
    register(
        "lock-mixed-guard", "unguarded-ok",
        "attribute written under a lock somewhere but accessed bare "
        "elsewhere (torn/stale shared state — the hazard reviews kept "
        "catching by hand)",
        lockgraph_scope,
    )(_check_for("lock-mixed-guard"))
    register(
        "lock-order-inversion", "lock-order-ok",
        "cycle in the cross-class lock-acquisition order graph (two "
        "threads taking the same locks in opposite orders can deadlock)",
        lockgraph_scope,
        # This rule consumes its marker inside the graph build (an
        # exempted edge never reaches cycle detection), so it reports
        # the consumed spans for the stale-marker audit itself.
        covered=lambda sf: analyze(sf.root).marker_hits.get(sf.rel, ()),
    )(_check_for("lock-order-inversion"))
    register(
        "callback-under-lock", "callback-ok",
        "callback/listener invoked while holding a lock (unknown code "
        "under a held mutex — the ledger-bug shape)",
        lockgraph_scope,
    )(_check_for("callback-under-lock"))
