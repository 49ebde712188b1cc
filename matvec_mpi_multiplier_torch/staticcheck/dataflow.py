"""Whole-program value flow for the build- and capture-hazard rules (#17–#20).

The port's counterpart of the JAX package's ``staticcheck/dataflow.py``,
with the same four rule names and markers, each read the port's way. The
port does not trace: a program is a Python function built once per ExecKey
(``MatvecStrategy.build``, ``build_solver``, ``build_speculative``) and, on
one card, captured once as a CUDA graph. The hazards are what mints a new
build or capture, or syncs:

- #17 ``traced-python-branch`` — ``if``/``while``/``assert`` on a value
  derived from a device tensor inside a program body (a function built by a
  ``build*`` function, a captured chunk, a device-loop iteration, and what
  they call). On the card it is a hidden sync; under CUDA-graph capture the
  branch freezes at capture and every replay takes the captured side.
- #18 ``weak-type-cache-split`` — a float-typed or per-request Python value
  (a float literal, a ``float()`` or a true division, ``rtol``, ``p0``,
  ``p1``, ``maxiter``, ``interval``) reaching an ``ExecKey`` field or a build
  or capture cache key: one build or capture per value, where the engine's
  signature ``fn(a, b, rtol, maxiter, p0, p1)`` takes those as arguments.
- #19 ``unhashable-static-arg`` — a dict, list, set, lambda or comprehension
  reaching an ``ExecKey`` field or a cache key: a ``TypeError`` at the first
  dispatch, or, for a lambda, a new key on every call.
- #20 ``host-sync-on-tracer`` — ``int()``, ``float()``, ``bool()``,
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` or ``np.asarray`` on a
  device tensor in ``engine/`` and ``solvers/``: the ``engine-host-sync``
  rule knows the method names, this one knows which values are tensors.

"Derived from a device tensor" is a taint: the result of a ``torch.*`` call
(minus the calls that return host values: dtypes, devices, generators,
``torch.finfo``, ``torch.is_tensor``, ...), a parameter of a captured
function, and anything computed from those; ``.shape``, ``.dtype``,
``.device``, ``.dim()``, ``.numel()``, ``len``, ``isinstance`` and ``is``
strip it, as static attributes do under a JAX trace. The analysis is the
JAX engine's: whole-program over the package (one cached build keyed on a
content hash, invalidated by :func:`new_generation`), pure ``ast``, taint
flow-insensitive within a function and propagated to a fixpoint across
direct calls resolved by name (same module, ``self.`` methods, then a unique
bare name).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
from pathlib import Path
from typing import Iterator

from .corpus import SourceFile, iter_corpus, source_file

_PKG = "matvec_mpi_multiplier_torch"

DATAFLOW_RULES = (
    "traced-python-branch",
    "weak-type-cache-split",
    "unhashable-static-arg",
    "host-sync-on-tracer",
)

# Taint facets.
TRACED = "traced"      # value may be a device tensor (or derived from one)
WEAK = "weak"          # float-typed or per-request Python value
UNHASH = "unhashable"  # dict/list/set/lambda/comprehension


def dataflow_scope(rel: str) -> bool:
    """The engine analyzes (and rules #17–#19 report over) the package:
    tests and ``chip_smoke.py`` drive engines from host code, where these
    hazards are the caller's business, not the serving path's."""
    return rel.startswith(f"{_PKG}/")


def sync_scope(rel: str) -> bool:
    """Rule #20 reports over the engine and solver paths."""
    return rel.startswith(f"{_PKG}/engine/") or rel.startswith(f"{_PKG}/solvers/")


# Capture and device-loop entry points -> positions whose function argument
# becomes a program body (its parameters are device tensors). Matched on the
# alias-resolved dotted name or its last component (the package imports
# them relatively): ``ops/graphs.py::capture``, ``solvers/device_loop.py``'s
# ``ChunkedLoop`` and ``when``, and ``torch.cuda.graphs.make_graphed_callables``.
_CAPTURE_CALLS: dict[str, tuple[int, ...]] = {
    "capture": (0,),
    "ChunkedLoop": (0,),
    "when": (1, 2),
    "make_graphed_callables": (0,),
}

# A function defined inside one of these builds a program: the nested
# function is the program body (models, solvers, the speculative check).
_BUILDER_PREFIXES = ("build", "_build", "local_body", "batched_body")

# Calls whose result is the engine's build identity: every argument is a
# key field (#18, #19). ``._replace`` of an ExecKey too.
_KEY_CALLS = frozenset({"ExecKey"})
# Cache lookups keyed by their first argument: the executable cache, the
# engine's shared functions and the solver's device-loop states.
_KEY_RECEIVERS = ("_cache", "_fns", "cache", "_states", "loops", "states")

# The per-request knobs of the served signature fn(a, b, rtol, maxiter, p0,
# p1) and of submit: Python values that change per request.
_REQUEST_KNOBS = frozenset({"rtol", "maxiter", "p0", "p1", "interval", "deadline_ms"})

# Attribute reads that are host values of a tensor: they strip the taint.
_STATIC_ATTRS = frozenset({
    "shape", "ndim", "dtype", "device", "is_cuda", "layout", "itemsize",
    "nbytes", "block", "fmt", "out_dtype", "requires_grad", "is_meta",
    # A sharded tensor's mesh and its host-side layout.
    "mesh", "spans_processes", "owners", "rank", "spec", "devices",
})
# Tensor methods whose result is a host value of the tensor's metadata.
_STATIC_METHODS = frozenset({
    "dim", "numel", "size", "element_size", "is_contiguous", "data_ptr",
    "stride", "get_device", "nelement", "is_floating_point", "is_complex",
    "storage_offset", "untyped_storage",
})

# Calls whose result is static regardless of argument taint.
_STRIP_CALLS = frozenset({
    "len", "isinstance", "issubclass", "hasattr", "type", "id", "callable",
    "repr", "str", "format", "getattr",
})

# torch calls that return host values (no tensor): they start no taint.
_TORCH_HOST_CALLS = frozenset({
    "torch.device", "torch.dtype", "torch.finfo", "torch.iinfo",
    "torch.Generator", "torch.is_tensor", "torch.is_floating_point",
    "torch.promote_types", "torch.result_type", "torch.get_default_dtype",
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.cuda.get_device_name",
    "torch.cuda.get_device_properties", "torch.cuda.is_current_stream_capturing",
    "torch.cuda.current_stream", "torch.cuda.Stream", "torch.cuda.Event",
    "torch.cuda.CUDAGraph", "torch.cuda.device", "torch.cuda.stream",
    "torch.cuda.graph", "torch.cuda.synchronize", "torch.no_grad",
    "torch.inference_mode", "torch.enable_grad", "torch.Size",
    "torch.cuda.memory_allocated", "torch.cuda.max_memory_allocated",
    "torch.cuda.set_sync_debug_mode", "torch.cuda.get_sync_debug_mode",
    "torch.profiler.record_function", "torch.cuda.nvtx.range_push",
    "torch.cuda.nvtx.range_pop", "torch.cuda.mem_get_info",
})

# Host-materialization calls: applied to a device tensor they sync; their
# results are host values.
_HOST_SYNC_CALLS = frozenset({
    "int", "float", "bool", "complex",
    "numpy.asarray", "numpy.array", "numpy.asanyarray",
})
_HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# Host calls whose result is float-typed.
_FLOAT_RESULT_CALLS = frozenset({"float", "math.sqrt", "math.log", "math.exp"})


@dataclasses.dataclass
class _Func:
    """One analyzed function (or a file's module-level pseudo-function)."""

    rel: str
    qual: str
    name: str
    node: ast.AST           # FunctionDef / AsyncFunctionDef / Module
    params: tuple[str, ...]
    cls: str | None
    parent: "_Func | None" = None  # the enclosing function (closures)
    traced_root: bool = False   # params are device tensors (capture boundary)
    ctx_traced: bool = False    # body runs inside a built or captured program
    env: dict = dataclasses.field(default_factory=dict)
    ret: frozenset = frozenset()
    binds: list = dataclasses.field(default_factory=list)
    sites: list = dataclasses.field(default_factory=list)

    @property
    def body(self) -> list:
        return self.node.body


_BIND_NODES = (
    ast.Assign, ast.AnnAssign, ast.AugAssign, ast.For, ast.AsyncFor,
    ast.With, ast.AsyncWith, ast.Return, ast.NamedExpr, ast.Expr,
)
_SITE_NODES = (ast.If, ast.While, ast.Assert, ast.Call)
_STMT_BEARING = (ast.stmt, ast.ExceptHandler, ast.match_case)


def _walk_own(body: list) -> Iterator[ast.AST]:
    """Walk a function body WITHOUT descending into nested function /
    lambda bodies (those are separate ``_Func``s with their own taint
    context). The guard is on the POPPED node, not the pushed child —
    a def sitting directly in the statement list (or a module's
    top-level defs) must not leak its locals into the enclosing env."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


_UNRESOLVED = object()  # memo sentinel: "not computed yet" != "None"


class Program:
    """The whole-program taint analysis: built once per corpus content
    hash, consumed by the per-file rule checks."""

    def __init__(self, root: Path) -> None:
        self.root = Path(root)
        self.funcs: dict[tuple[str, str], _Func] = {}
        self.by_file: dict[str, dict[str, _Func]] = {}
        self.by_bare: dict[str, list[_Func]] = {}
        self.by_method: dict[tuple[str, str], list[_Func]] = {}
        self.by_method_name: dict[str, list[_Func]] = {}
        self.by_node: dict[int, _Func] = {}
        self.modules: dict[str, _Func] = {}
        self.aliases: dict[str, dict[str, str]] = {}
        self.findings: dict[str, dict[str, list]] = {
            rule: {} for rule in DATAFLOW_RULES
        }
        self.callers: dict[tuple[str, str], set] = {}
        self._dirty: set[tuple[str, str]] = set()
        self._resolve_cache: dict[tuple[str, str | None, int], object] = {}
        self._dotted_cache: dict[tuple[str, int], str | None] = {}
        self._changed = False
        self._build()

    # ---- construction ----

    def _build(self) -> None:
        sources: list[SourceFile] = []
        for path in iter_corpus(self.root):
            rel = path.relative_to(self.root).as_posix()
            if not dataflow_scope(rel):
                continue
            try:
                sources.append(source_file(path, self.root))
            except (SyntaxError, UnicodeDecodeError):
                continue  # rules.py reports parse errors separately
        for sf in sources:
            self._collect(sf)
        for sf in sources:
            self._mark_traced(sf)
        # Interprocedural fixpoint over a worklist: taint facets only
        # ever GROW (a finite monotone lattice), so re-processing only
        # functions whose inputs changed terminates — and keeps the
        # whole-program pass at tier-1 --rules speed.
        pending = list(self.funcs)
        in_queue = set(pending)
        rounds = 0
        limit = 50 * max(1, len(self.funcs))
        while pending and rounds < limit:
            rounds += 1
            key = pending.pop()
            in_queue.discard(key)
            fn = self.funcs[key]
            self._seed(fn)
            ret_before = fn.ret
            ctx_before = fn.ctx_traced
            for _ in range(4):
                self._dirty.clear()
                changed = self._local_pass(fn)
                for dirty_key in self._dirty:
                    if dirty_key != key and dirty_key not in in_queue:
                        pending.append(dirty_key)
                        in_queue.add(dirty_key)
                if not changed:
                    break
            if fn.ret != ret_before or fn.ctx_traced != ctx_before:
                for caller in self.callers.get(key, ()):
                    if caller not in in_queue:
                        pending.append(caller)
                        in_queue.add(caller)
        for fn in self.funcs.values():
            self._check(fn)

    def _collect(self, sf: SourceFile) -> None:
        self.aliases[sf.rel] = dict(sf.aliases)
        file_funcs: dict[str, _Func] = {}
        module = _Func(
            rel=sf.rel, qual="<module>", name="<module>", node=sf.tree,
            params=(), cls=None,
        )
        self._index(module)
        self.modules[sf.rel] = module
        self.funcs[(sf.rel, "<module>")] = module
        self.by_node[id(sf.tree)] = module

        def visit(node: ast.AST, cls: str | None, prefix: str,
                  parent: _Func | None = None) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name, f"{prefix}{child.name}.", parent)
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    qual = f"{prefix}{child.name}"
                    if (sf.rel, qual) in self.funcs:
                        # A second def of one name in one scope (a builder's
                        # branches each define their program body).
                        qual = f"{qual}@{child.lineno}"
                    params = tuple(
                        a.arg for a in (
                            child.args.posonlyargs + child.args.args
                            + child.args.kwonlyargs
                        )
                    )
                    fn = _Func(
                        rel=sf.rel, qual=qual, name=child.name, node=child,
                        params=params, cls=cls,
                        # A function defined inside a builder is the
                        # program body it builds.
                        ctx_traced=".<locals>." in qual and qual.split(".<locals>.")[-2]
                        .rsplit(".", 1)[-1].startswith(_BUILDER_PREFIXES),
                        parent=parent,
                    )
                    self._index(fn)
                    self.funcs[(sf.rel, qual)] = fn
                    self.by_node[id(child)] = fn
                    file_funcs.setdefault(child.name, fn)
                    self.by_bare.setdefault(child.name, []).append(fn)
                    if cls is not None:
                        self.by_method.setdefault(
                            (cls, child.name), []
                        ).append(fn)
                        self.by_method_name.setdefault(
                            child.name, []
                        ).append(fn)
                    visit(child, cls, f"{qual}.<locals>.", fn)
                elif isinstance(child, _STMT_BEARING):
                    # Defs are statements; only statement-bearing nodes
                    # (stmt bodies, except handlers, match cases) can
                    # contain one. Expression subtrees hold at most
                    # lambdas, which this collector never models — so
                    # pruning them is exact, not an approximation.
                    visit(child, cls, prefix, parent)

        visit(sf.tree, None, "")
        self.by_file[sf.rel] = file_funcs

    def _index(self, fn: _Func) -> None:
        """One own-body walk, bucketing the nodes the taint pass
        (``binds``) and the rule checks (``sites``) iterate."""
        for node in _walk_own(fn.body):
            if isinstance(node, _BIND_NODES):
                fn.binds.append(node)
            if isinstance(node, _SITE_NODES):
                fn.sites.append(node)

    def _dotted(self, rel: str, expr: ast.expr) -> str | None:
        key = (rel, id(expr))
        hit = self._dotted_cache.get(key, _UNRESOLVED)
        if hit is not _UNRESOLVED:
            return hit
        parts: list[str] = []
        node = expr
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            out = None
        else:
            aliases = self.aliases.get(rel, {})
            parts.append(aliases.get(node.id, node.id))
            out = ".".join(reversed(parts))
        self._dotted_cache[key] = out
        return out

    def _capture_positions(self, dotted: str | None) -> tuple[int, ...] | None:
        if dotted is None:
            return None
        return _CAPTURE_CALLS.get(dotted.rsplit(".", 1)[-1])

    def _resolve(
        self, rel: str, cls: str | None, expr: ast.expr
    ) -> _Func | None:
        """Resolve a call target to an analyzed function: same-module
        name, ``self.method`` (same class first), then a UNIQUE bare
        name anywhere in the program. Memoized per call site — the
        fixpoint re-evaluates expressions many times."""
        key = (rel, cls, id(expr))
        hit = self._resolve_cache.get(key, _UNRESOLVED)
        if hit is not _UNRESOLVED:
            return hit
        out = self._resolve_uncached(rel, cls, expr)
        self._resolve_cache[key] = out
        return out

    def _resolve_uncached(
        self, rel: str, cls: str | None, expr: ast.expr
    ) -> _Func | None:
        if isinstance(expr, ast.Name):
            fn = self.by_file.get(rel, {}).get(expr.id)
            if fn is not None:
                return fn
            candidates = self.by_bare.get(expr.id, [])
            if len(candidates) == 1:
                return candidates[0]
            return None
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            if cls is not None:
                same = [
                    f for f in self.by_method.get((cls, expr.attr), [])
                    if f.rel == rel
                ]
                if same:
                    return same[0]
            candidates = self.by_method_name.get(expr.attr, [])
            if len(candidates) == 1:
                return candidates[0]
        return None

    def _mark_traced(self, sf: SourceFile) -> None:
        """Functions handed to a capture or device-loop entry point are
        program bodies whose parameters are device tensors."""
        rel = sf.rel
        for node in sf.nodes(ast.Call):
            positions = self._capture_positions(self._dotted(rel, node.func))
            if positions is None:
                continue
            owner = self._owner(sf, node)
            for i in positions:
                if i < len(node.args):
                    fn = self._resolve(rel, owner, node.args[i])
                    if fn is not None:
                        fn.traced_root = fn.ctx_traced = True

    def _owner(self, sf: SourceFile, node: ast.AST) -> str | None:
        """The class whose method contains ``node`` (for ``self.`` calls)."""
        for cls in sf.nodes(ast.ClassDef):
            if cls.lineno <= node.lineno <= (cls.end_lineno or cls.lineno):
                return cls.name
        return None

    # ---- taint ----

    def _seed(self, fn: _Func) -> None:
        for p in fn.params:
            if p == "self":
                continue
            seed = (frozenset({TRACED}) if fn.traced_root else frozenset()) | (
                frozenset({WEAK}) if p in _REQUEST_KNOBS else frozenset())
            if seed - fn.env.get(p, frozenset()):
                fn.env[p] = fn.env.get(p, frozenset()) | seed
                self._changed = True

    def _merge(self, fn: _Func, name: str, taint: frozenset) -> bool:
        old = fn.env.get(name, frozenset())
        new = old | taint
        if new != old:
            fn.env[name] = new
            return True
        return False

    def _bind(
        self,
        fn: _Func,
        target: ast.expr,
        taint: frozenset,
        value: ast.expr | None = None,
    ) -> bool:
        changed = False
        if isinstance(target, ast.Name):
            changed |= self._merge(fn, target.id, taint)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if (
                isinstance(value, (ast.Tuple, ast.List))
                and len(value.elts) == len(target.elts)
                and not any(
                    isinstance(e, ast.Starred) for e in target.elts
                )
            ):
                # `a, b = x, [y]` — element-wise, so the display's
                # UNHASH lands only on the name actually bound to it.
                for elt, velt in zip(target.elts, value.elts):
                    changed |= self._bind(
                        fn, elt, self._taint(fn, velt), velt
                    )
            else:
                # Unpacking a container yields ELEMENTS — the
                # container's own unhashability does not transfer.
                for elt in target.elts:
                    changed |= self._bind(fn, elt, taint - {UNHASH})
        elif isinstance(target, ast.Starred):
            changed |= self._bind(fn, target.value, taint)
        return changed

    def _taint(self, fn: _Func, node: ast.expr) -> frozenset:
        if isinstance(node, ast.Name):
            local = fn.env.get(node.id)
            if local is not None:
                return local
            outer = fn.parent
            while outer is not None:  # a closure's free variable
                if node.id in outer.env:
                    return outer.env[node.id]
                outer = outer.parent
            module = self.modules.get(fn.rel)
            if module is not None and module is not fn:
                return module.env.get(node.id, frozenset())
            return frozenset()
        if isinstance(node, ast.Constant):
            # A float literal is float-typed; an int is a legitimate key
            # part (a bucket, a stage count).
            if isinstance(node.value, (float, complex)):
                return frozenset({WEAK})
            return frozenset()
        if isinstance(node, ast.Attribute):
            base = self._taint(fn, node.value)
            if node.attr in _STATIC_ATTRS:
                return base - {TRACED, WEAK}
            return base - {WEAK}
        if isinstance(node, ast.Subscript):
            # Indexing yields an ELEMENT: a tracer stays a tracer, but
            # the container's unhashability does not ride along.
            return self._taint(fn, node.value) - {UNHASH}
        if isinstance(node, ast.BinOp):
            # A per-request or float value taints the arithmetic on it, and
            # a true division is float-typed; a tensor result is no key part.
            out = self._taint(fn, node.left) | self._taint(fn, node.right)
            if isinstance(node.op, ast.Div):
                out |= {WEAK}
            return out - {WEAK} if TRACED in out else out
        if isinstance(node, ast.UnaryOp):
            return self._taint(fn, node.operand)
        if isinstance(node, ast.BoolOp):
            out: frozenset = frozenset()
            for v in node.values:
                out |= self._taint(fn, v)
            return out
        if isinstance(node, ast.Compare):
            # A comparison's result is a bool (or a traced bool array)
            # — never a weak literal or an unhashable container.
            out = self._taint(fn, node.left)
            for c in node.comparators:
                out |= self._taint(fn, c)
            out -= {WEAK, UNHASH}
            if all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
            ):
                out -= {TRACED}
            return out
        if isinstance(node, ast.Call):
            return self._call_taint(fn, node)
        if isinstance(node, ast.Tuple):
            out = frozenset()
            for elt in node.elts:
                out |= self._taint(fn, elt)
            return out
        if isinstance(node, (ast.List, ast.Set)):
            out = frozenset({UNHASH})
            for elt in node.elts:
                out |= self._taint(fn, elt)
            return out
        if isinstance(node, ast.Dict):
            out = frozenset({UNHASH})
            for v in node.values:
                if v is not None:
                    out |= self._taint(fn, v)
            return out
        if isinstance(node, ast.Lambda):
            return frozenset({UNHASH})
        if isinstance(
            node,
            (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp),
        ):
            return frozenset({UNHASH})
        if isinstance(node, ast.IfExp):
            return self._taint(fn, node.body) | self._taint(fn, node.orelse)
        if isinstance(node, ast.Starred):
            return self._taint(fn, node.value)
        if isinstance(node, ast.NamedExpr):
            return self._taint(fn, node.value)
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
            return frozenset()
        return frozenset()

    def _call_taint(self, fn: _Func, call: ast.Call) -> frozenset:
        dotted = self._dotted(fn.rel, call.func)
        arg_taints = [self._taint(fn, a) for a in call.args]
        kw_taints = {
            kw.arg: self._taint(fn, kw.value)
            for kw in call.keywords if kw.arg is not None
        }
        merged: frozenset = frozenset()
        for t in arg_taints:
            merged |= t
        for t in kw_taints.values():
            merged |= t
        if isinstance(call.func, ast.Attribute):
            if call.func.attr in _STATIC_METHODS:
                return frozenset()
            if call.func.attr in _HOST_SYNC_METHODS:
                return frozenset({WEAK}) if call.func.attr == "item" else frozenset()
            # Method calls: the receiver's taint rides the result (x.sum()
            # of a device tensor is one).
            merged |= self._taint(fn, call.func.value) - {WEAK}
        callee = self._resolve(fn.rel, fn.cls, call.func)
        if callee is not None and callee is not fn:
            ckey = (callee.rel, callee.qual)
            self.callers.setdefault(ckey, set()).add((fn.rel, fn.qual))
            changed = False
            params = [p for p in callee.params if p != "self"]
            for i, t in enumerate(arg_taints):
                if i < len(params) and t:
                    changed |= self._merge(callee, params[i], t)
            for name, t in kw_taints.items():
                if name in callee.params and t:
                    changed |= self._merge(callee, name, t)
            if fn.ctx_traced and not callee.ctx_traced:
                callee.ctx_traced = True
                changed = True
            if changed:
                self._dirty.add(ckey)
            return callee.ret
        if dotted in _STRIP_CALLS:
            return frozenset()
        if dotted in _FLOAT_RESULT_CALLS:
            return frozenset({WEAK})
        if dotted in _HOST_SYNC_CALLS:
            return frozenset()
        if dotted is not None and dotted.startswith("torch."):
            return frozenset() if dotted in _TORCH_HOST_CALLS else frozenset({TRACED})
        # Unresolved call: the tensor taint flows through; the float,
        # per-request and unhashable facets do not (a call's result is no
        # literal or display).
        return frozenset({TRACED} if TRACED in merged else ())

    def _local_pass(self, fn: _Func) -> bool:
        changed = False
        for node in fn.binds:
            if isinstance(node, ast.Assign):
                t = self._taint(fn, node.value)
                for tgt in node.targets:
                    changed |= self._bind(fn, tgt, t, node.value)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                changed |= self._bind(
                    fn, node.target, self._taint(fn, node.value),
                    node.value,
                )
            elif isinstance(node, ast.AugAssign):
                t = self._taint(fn, node.value) | self._taint(
                    fn, node.target
                )
                changed |= self._bind(fn, node.target, t)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                # Iteration yields ELEMENTS of the iterable — a traced
                # element stays traced, list-ness does not transfer.
                changed |= self._bind(
                    fn, node.target,
                    self._taint(fn, node.iter) - {UNHASH},
                )
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        changed |= self._bind(
                            fn, item.optional_vars,
                            self._taint(fn, item.context_expr),
                        )
            elif isinstance(node, ast.Return) and node.value is not None:
                new = fn.ret | self._taint(fn, node.value)
                if new != fn.ret:
                    fn.ret = new
                    changed = True
            elif isinstance(node, ast.NamedExpr):
                changed |= self._bind(
                    fn, node.target, self._taint(fn, node.value)
                )
            elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                # A call made for its effect still hands taint and the
                # program-body context to its callee.
                self._taint(fn, node.value)
        if changed:
            self._changed = True
        return changed

    # ---- rule checks ----

    def _emit(self, rule: str, fn: _Func, node: ast.AST, msg: str) -> None:
        self.findings[rule].setdefault(fn.rel, []).append((node, msg))

    def _key_exprs(self, fn: _Func, call: ast.Call) -> list[tuple[ast.expr, str]]:
        """The expressions of ``call`` that become a build identity: every
        argument of an ExecKey, the first of a cache lookup."""
        func = call.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None)
        if name in _KEY_CALLS:
            return ([(a, f"ExecKey field {i}") for i, a in enumerate(call.args)]
                    + [(kw.value, f"ExecKey field {kw.arg!r}") for kw in call.keywords
                       if kw.arg is not None])
        if (name == "get" and isinstance(func, ast.Attribute) and call.args
                and isinstance(func.value, (ast.Attribute, ast.Name))
                and (func.value.attr if isinstance(func.value, ast.Attribute)
                     else func.value.id) in _KEY_RECEIVERS):
            return [(call.args[0], "a cache key")]
        return []

    def _check(self, fn: _Func) -> None:
        in_sync_scope = sync_scope(fn.rel)
        for node in fn.sites:
            if fn.ctx_traced and isinstance(node, (ast.If, ast.While, ast.Assert)):
                if TRACED in self._taint(fn, node.test):
                    kind = type(node).__name__.lower()
                    self._emit(
                        "traced-python-branch", fn, node,
                        f"Python `{kind}` on a device-tensor value inside a program "
                        f"body ({fn.qual}) — a hidden host sync on the card, and "
                        "under CUDA-graph capture the branch freezes at capture "
                        "and every replay takes the captured side; keep it on the "
                        "device (torch.where, a launch predicate) or branch on "
                        "static .shape/.dtype/.device")
            if not isinstance(node, ast.Call):
                continue
            call = node
            if in_sync_scope:
                self._check_sync(fn, call)
            for expr, where in self._key_exprs(fn, call):
                taint = self._taint(fn, expr)
                if UNHASH in taint:
                    self._emit(
                        "unhashable-static-arg", fn, expr,
                        f"unhashable value reaches {where} — build and capture "
                        "keys must hash: a TypeError at the first dispatch, or a "
                        "new key per call for a lambda; pass a tuple or a frozen "
                        "config")
                elif WEAK in taint and TRACED not in taint:
                    self._emit(
                        "weak-type-cache-split", fn, expr,
                        f"a float-typed or per-request Python value reaches {where} "
                        "— one build or capture per value, where the served "
                        "signature fn(a, b, rtol, maxiter, p0, p1) takes it as an "
                        "argument")

    def _check_sync(self, fn: _Func, call: ast.Call) -> None:
        dotted = self._dotted(fn.rel, call.func)
        if dotted in _HOST_SYNC_CALLS:
            hit = any(TRACED in self._taint(fn, a) for a in call.args)
            what = f"{dotted}()"
        elif (isinstance(call.func, ast.Attribute)
              and call.func.attr in _HOST_SYNC_METHODS):
            hit = TRACED in self._taint(fn, call.func.value)
            what = f".{call.func.attr}()"
        else:
            return
        if hit:
            self._emit(
                "host-sync-on-tracer", fn, call,
                f"{what} on a device tensor in {fn.qual} — a host read that "
                "waits for the card (and fails under graph capture); keep the "
                "value on the device, or mark the one deliberate read")


# ---- cache + rule registration (the lockgraph pattern) ----

# root -> (generation, content signature, program).
_CACHE: dict[str, tuple[int, tuple, Program]] = {}
_GENERATION = [0]


def new_generation() -> None:
    """Invalidate the once-per-run corpus validation (rules.run_rules
    calls this at entry; a direct ``analyze`` caller that mutates files
    between calls must call it too)."""
    _GENERATION[0] += 1


def analyze(root: Path) -> Program:
    """The corpus's value-flow program, rebuilt only when an in-scope
    file's content changes, validated at most once per rule-engine run."""
    root = Path(root)
    key = str(root.resolve())
    gen = _GENERATION[0]
    cached = _CACHE.get(key)
    if cached is not None and cached[0] == gen:
        return cached[2]
    sig = []
    for path in iter_corpus(root):
        rel = path.relative_to(root).as_posix()
        if dataflow_scope(rel):
            sig.append(
                (rel, hashlib.sha1(path.read_bytes()).hexdigest())
            )
    sig_t = tuple(sig)
    if cached is not None and cached[1] == sig_t:
        program = cached[2]
    else:
        program = Program(root)
    _CACHE[key] = (gen, sig_t, program)
    return program


def _check_for(rule: str):
    def check(sf: SourceFile) -> Iterator[tuple[ast.AST, str]]:
        yield from analyze(sf.root).findings[rule].get(sf.rel, [])

    return check


def register_dataflow_rules(register) -> None:
    """Hook the four value-flow rules into the ordinary rule registry
    (rules.py calls this before computing MARKERS)."""
    register(
        "traced-python-branch", "traced-branch-ok",
        "if/while/assert on a device-tensor value inside a built or captured "
        "program body (a hidden sync; frozen at capture)",
        dataflow_scope,
    )(_check_for("traced-python-branch"))
    register(
        "weak-type-cache-split", "weak-type-ok",
        "float-typed or per-request Python value reaching an ExecKey field or "
        "a build/capture cache key (one build per value)",
        dataflow_scope,
    )(_check_for("weak-type-cache-split"))
    register(
        "unhashable-static-arg", "static-arg-ok",
        "dict/list/set/lambda reaching an ExecKey field or a cache key "
        "(TypeError at first dispatch, or a new key per call)",
        dataflow_scope,
    )(_check_for("unhashable-static-arg"))
    register(
        "host-sync-on-tracer", "tracer-sync-ok",
        "int()/float()/bool()/.item()/.tolist()/.cpu()/.numpy()/np.asarray on "
        "a device tensor in engine/ and solvers/",
        sync_scope,
    )(_check_for("host-sync-on-tracer"))
