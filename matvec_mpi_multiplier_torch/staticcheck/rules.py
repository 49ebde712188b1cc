"""The AST rule engine: registry, exemption markers, and the rule catalogue.

The port's counterpart of the JAX package's ``staticcheck/rules.py``: the
same registry, marker scheme and stale-marker check, with the rules read
for the port's tree. Each rule is a small checker over one parsed
:class:`~.corpus.SourceFile`, scoped to the paths where its invariant
holds, with an optional exemption marker. A finding on a statement is
suppressed when any comment on the statement's physical lines carries
``# <marker>: <reason>``; every marker occurrence in a rule's scope must be
a real comment with a non-empty reason, and must sit where its rule fires
(a marker that no longer covers a finding is ``stale-marker``).

Rule catalogue (README.md's rule table is held equal to it by a test):

===================================  ===============  ==========================
rule                                 marker           invariant
===================================  ===============  ==========================
jax-import                           —                the port imports no jax
                                                      and nothing of the JAX
                                                      package
engine-host-sync                     sync-ok          no host sync on the
                                                      engine's dispatch path
overlap-unchunked-collective         overlap-ok       no full-width collective
                                                      in a staged body
hot-path-blocking-io                 obs-ok           no file I/O on the
                                                      dispatch hot path
fp64-implicit-promotion              fp64-ok          no unstated float64
import-time-torch                    import-ok        no tensor, CUDA call or
                                                      kernel build at import
mutable-default-arg                  default-ok       no mutable defaults
scheduler-lock-across-dispatch       lock-ok          no dispatch under a held
                                                      scheduler lock
silent-except                        swallow-ok       broad excepts re-raise,
                                                      record, or justify
quant-fp64-scale                     quant-ok         scales are fp32
device-transfer-under-registry-lock  registry-ok      no placement, dispatch or
                                                      sync under a registry lock
measurement-in-admission-path        admit-ok         admission never measures
metric-label-cardinality             cardinality-ok   no per-iteration series
lock-mixed-guard                     unguarded-ok     (lockgraph.py)
lock-order-inversion                 lock-order-ok    (lockgraph.py)
callback-under-lock                  callback-ok      (lockgraph.py)
traced-python-branch                 traced-branch-ok (dataflow.py)
weak-type-cache-split                weak-type-ok     (dataflow.py)
unhashable-static-arg                static-arg-ok    (dataflow.py)
host-sync-on-tracer                  tracer-sync-ok   (dataflow.py)
===================================  ===============  ==========================

Nine rules keep the JAX package's bodies (their fixtures give the same
findings in both packages' layouts). Four are the port's readings of the
JAX-specific ones: ``engine-host-sync`` looks for ``.item()``, ``.cpu()``,
``.tolist()``, ``.numpy()`` and ``synchronize()`` instead of
``block_until_ready``; ``import-time-torch`` replaces ``import-time-jnp``;
``fp64-implicit-promotion`` looks for float64 reaching torch;
``jax-import`` replaces ``shard-map-direct`` and is the static twin of
``tests/test_torch_purity.py``.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Callable, Iterable, Iterator

from .corpus import SourceFile, iter_corpus, repo_root, source_file
from .findings import Finding, dedup
from .dataflow import new_generation as dataflow_new_generation
from .dataflow import register_dataflow_rules
from .lockgraph import new_generation as lockgraph_new_generation
from .lockgraph import register_lockgraph_rules

# ------------------------------------------------------------ framework

_PKG = "matvec_mpi_multiplier_torch"
_JAX_PKG = "matvec_mpi_multiplier_tpu"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered invariant: where it applies, how it checks, how a
    deliberate exception is marked."""

    name: str                       # slug used in findings and --rule
    marker: str | None              # "<marker>: <reason>" comment exempts
    description: str                # one line, shown by --list
    scope: Callable[[str], bool]    # repo-relative posix path predicate
    check: Callable[[SourceFile], Iterator[tuple[ast.AST, str]]]
    # Line spans where the rule consumed its marker INTERNALLY (before any
    # finding could surface — lock-order-inversion drops exempted edges
    # ahead of cycle detection). The stale-marker audit unions these into
    # its live coverage; None for rules whose raw findings reach run_rules.
    covered: Callable[[SourceFile], Iterable[int]] | None = None


RULES: dict[str, Rule] = {}


def _register(name, marker, description, scope, covered=None):
    def deco(fn):
        RULES[name] = Rule(name, marker, description, scope, fn, covered)
        return fn

    return deco


def get_rule(name: str) -> Rule:
    try:
        return RULES[name]
    except KeyError:
        raise KeyError(
            f"unknown rule {name!r}; available: {sorted(RULES)}"
        ) from None


def _markers() -> dict[str, str]:
    return {r.marker: r.name for r in RULES.values() if r.marker}


def _marker_at(comment: str, marker: str) -> int:
    """Where ``marker:`` starts in ``comment`` as a marker of its own (not
    the tail of a longer one: ``sync-ok:`` inside ``tracer-sync-ok:``), or
    -1."""
    token = f"{marker}:"
    start = comment.find(token)
    while start > 0 and (comment[start - 1].isalnum() or comment[start - 1] in "-_"):
        start = comment.find(token, start + 1)
    return start


def _has_marker(comment: str, marker: str) -> bool:
    return _marker_at(comment, marker) >= 0


def _marker_reason(comment: str, marker: str) -> str:
    return comment[_marker_at(comment, marker) + len(marker) + 1:].strip()


def _exempt(sf: SourceFile, node: ast.AST, marker: str) -> bool:
    return _has_marker(sf.span_comments(node), marker)


def _marker_reason_findings(
    sf: SourceFile, rules: Iterable[Rule]
) -> Iterator[Finding]:
    """Every marker occurrence in an in-scope file must carry a reason
    (comments only: marker text inside a string exempts nothing)."""
    for rule in rules:
        if not rule.marker:
            continue
        token = f"{rule.marker}:"
        if token not in sf.text:
            continue  # skip the tokenize pass for marker-free files
        for lineno, comment in sf.comments.items():
            if _has_marker(comment, rule.marker) and not _marker_reason(comment, rule.marker):
                yield Finding(
                    sf.rel, lineno, "marker-missing-reason",
                    f"'# {token}' without a reason (the {rule.name} "
                    f"exemption marker documents WHY, or it is an escape "
                    f"hatch)",
                )


STALE_MARKER = "stale-ok"


def _stale_marker_findings(
    sf: SourceFile, rules: Iterable[Rule], covered: dict[str, set[int]]
) -> Iterator[Finding]:
    """Exemption markers must sit where their rule actually FIRES: a rotted
    exemption silently blesses the next real finding at its site.
    ``covered`` maps each in-scope rule's marker to the line spans its raw
    (pre-exemption) findings touched this run; a marker comment outside
    every span is stale. The stale-ok marker keeps a deliberately
    anticipatory one (with its reason)."""
    stale_token = f"{STALE_MARKER}:"
    for rule in rules:
        if not rule.marker:
            continue
        token = f"{rule.marker}:"
        if token not in sf.text:
            continue
        live = covered.get(rule.marker, set())
        for lineno, comment in sf.comments.items():
            if not _has_marker(comment, rule.marker) or lineno in live:
                continue
            if stale_token in comment:
                if not comment.split(stale_token, 1)[1].strip():
                    yield Finding(
                        sf.rel, lineno, "marker-missing-reason",
                        f"'# {stale_token}' without a reason (the "
                        f"stale-marker escape hatch documents WHY the "
                        f"marker is kept ahead of its rule)",
                    )
                continue
            yield Finding(
                sf.rel, lineno, "stale-marker",
                f"'# {token}' comment but {rule.name} no longer fires "
                f"at this site — the exemption has rotted; drop the "
                f"marker, or keep it deliberately with "
                f"'# {stale_token} reason'",
                marker=STALE_MARKER,
            )


def run_rules(
    root: Path | None = None,
    rules: Iterable[str] | None = None,
) -> list[Finding]:
    """Run the (selected) rule catalogue over the corpus under ``root``
    (the repo by default). Returns sorted, deduplicated findings — empty
    means the tree is clean."""
    root = Path(root) if root is not None else repo_root()
    selected = (
        list(RULES.values()) if rules is None
        else [get_rule(n) for n in rules]
    )
    # One corpus validation per run for the whole-program analyses.
    lockgraph_new_generation()
    dataflow_new_generation()
    findings: list[Finding] = []
    for path in iter_corpus(root):
        try:
            sf = source_file(path, root)
        except (SyntaxError, UnicodeDecodeError) as e:
            rel = path.relative_to(root).as_posix()
            findings.append(
                Finding(rel, getattr(e, "lineno", 0) or 0, "parse-error",
                        f"unparseable source: {e}")
            )
            continue
        in_scope = [r for r in selected if r.scope(sf.rel)]
        covered: dict[str, set[int]] = {}
        for rule in in_scope:
            if rule.marker and rule.covered is not None:
                covered.setdefault(rule.marker, set()).update(
                    rule.covered(sf)
                )
            for node, message in rule.check(sf):
                if rule.marker:
                    lineno = getattr(node, "lineno", 0)
                    end = getattr(node, "end_lineno", None) or lineno
                    covered.setdefault(rule.marker, set()).update(
                        range(lineno, end + 1)
                    )
                    if _exempt(sf, node, rule.marker):
                        continue
                findings.append(
                    Finding(sf.rel, getattr(node, "lineno", 0), rule.name,
                            message, marker=rule.marker)
                )
        findings.extend(_marker_reason_findings(sf, in_scope))
        findings.extend(_stale_marker_findings(sf, in_scope, covered))
    return dedup(findings)


def check_marker_reasons(
    marker: str, root: Path | None = None
) -> list[Finding]:
    """Reason-required check for ONE marker over its rule's scope."""
    rule = get_rule(MARKERS[marker])
    root = Path(root) if root is not None else repo_root()
    findings: list[Finding] = []
    for path in iter_corpus(root):
        rel = path.relative_to(root).as_posix()
        if not rule.scope(rel):
            continue
        try:
            sf = source_file(path, root)
        except (SyntaxError, UnicodeDecodeError):
            continue  # run_rules owns the parse-error finding
        findings.extend(_marker_reason_findings(sf, [rule]))
    return dedup(findings)


# ----------------------------------------------------------- AST helpers


def _calls(tree: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def _name_of(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _import_time_nodes(tree: ast.Module) -> Iterator[ast.AST]:
    """Expressions executed at import: module/class bodies plus function
    decorators and default-argument expressions — but never the deferred
    function/lambda bodies themselves."""
    stack: list[ast.AST] = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(node.decorator_list)
            stack.extend(_defaults(node.args))
        elif isinstance(node, ast.Lambda):
            stack.extend(_defaults(node.args))
        elif isinstance(node, ast.ClassDef):
            stack.extend(node.decorator_list)
            stack.extend(node.body)
        elif isinstance(node, ast.If) and _is_main_guard(node):
            # `if __name__ == "__main__":` runs only as a script.
            stack.extend(node.orelse)
        else:
            yield node
            stack.extend(ast.iter_child_nodes(node))


def _is_main_guard(node: ast.If) -> bool:
    test = node.test
    return (
        isinstance(test, ast.Compare)
        and isinstance(test.left, ast.Name) and test.left.id == "__name__"
        and any(isinstance(c, ast.Constant) and c.value == "__main__"
                for c in test.comparators)
    )


def _defaults(args: ast.arguments) -> list[ast.AST]:
    return list(args.defaults) + [d for d in args.kw_defaults if d]


# ------------------------------------------------------ scope predicates


def _engine(rel: str) -> bool:
    return rel.startswith(f"{_PKG}/engine/")


def _overlap_bodies(rel: str) -> bool:
    return rel in (f"{_PKG}/parallel/ring.py", f"{_PKG}/ops/collective.py")


def _hot_path(rel: str) -> bool:
    # engine/ plus the obs in-memory layer; the sink thread and the obs CLI
    # are the two files allowed to touch the filesystem by design.
    if _engine(rel):
        return True
    return rel.startswith(f"{_PKG}/obs/") and rel not in (
        f"{_PKG}/obs/sink.py", f"{_PKG}/obs/__main__.py",
    )


def _package(rel: str) -> bool:
    return rel.startswith(f"{_PKG}/")


def _port_programs(rel: str) -> bool:
    # The package and the card script: everything of the port that runs
    # without JAX (the tests import both packages by design).
    return _package(rel) or rel == "chip_smoke.py"


# The paths a request's dispatch runs through, where an unstated float64
# conversion of a host array would promote the served program.
_DISPATCH_DIRS = ("engine", "ops", "parallel", "models", "solvers")


def _on_dispatch_path(rel: str) -> bool:
    return any(rel.startswith(f"{_PKG}/{d}/") for d in _DISPATCH_DIRS)


# -------------------------------------------------------------- catalogue


def _is_jax_module(name: str) -> bool:
    top = name.split(".", 1)[0]
    return top in ("jax", "jaxlib", _JAX_PKG)


@_register(
    "jax-import", None,
    "an import of jax or of the JAX package inside the port (the port "
    "keeps its own copy of everything it needs)",
    _port_programs,
)
def _check_jax_import(sf: SourceFile):
    if "jax" not in sf.text and _JAX_PKG not in sf.text:
        return
    for node in sf.nodes(ast.Import, ast.ImportFrom, ast.Call):
        names: list[str] = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        elif isinstance(node, ast.Call):
            # importlib.import_module("jax") / __import__("jax")
            q = sf.qualname(node.func) or ""
            if q in ("importlib.import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    names = [arg.value]
        for name in names:
            if _is_jax_module(name):
                yield node, (
                    f"import of {name!r}: the port imports torch, never jax "
                    "and nothing of the JAX package (keep a copy of the "
                    "jax-free piece inside the port)"
                )
                break


# Method calls that read a device value back to the host (or wait for
# the device): on the dispatch path they turn async submit into
# per-request blocking.
_SYNC_ATTRS = ("item", "cpu", "tolist", "numpy", "synchronize")
_SYNC_CALLS = ("torch.cuda.synchronize", "torch.cuda.current_stream.synchronize")


@_register(
    "engine-host-sync", "sync-ok",
    "host synchronization on the engine dispatch path (.item(), .cpu(), "
    ".tolist(), .numpy(), torch.cuda.synchronize, Event.synchronize: "
    "breaks the async submit contract)",
    _engine,
)
def _check_host_sync(sf: SourceFile):
    for call in sf.nodes(ast.Call):
        fn = call.func
        q = sf.qualname(fn) or ""
        if q in _SYNC_CALLS:
            yield call, (
                f"{q}() waits for the device on the dispatch path (move it "
                "behind result(), or mark the deliberate wait with "
                "'# sync-ok: <reason>')"
            )
        elif isinstance(fn, ast.Attribute) and fn.attr in _SYNC_ATTRS \
                and not call.args:
            yield call, (
                f".{fn.attr}() host-syncs; a dispatch-path round-trip turns "
                "async submit into per-request blocking (materialize in "
                "result(), or mark the deliberate materialization point)"
            )


# Full-width collectives in a staged body: the port's mesh collectives
# plus the JAX spellings, so the JAX package's fixture reads the same here.
_FULL_WIDTH = ("psum", "psum_scatter", "unshard", "all_gather")


def _local_names(sf: SourceFile) -> dict[str, str]:
    """Local name -> imported name for every ``from ... import`` in the
    file, relative ones included (``from .mesh import psum as p``): the
    port's own modules are imported relatively, which the corpus's alias
    table leaves out."""
    table: dict[str, str] = {}
    for node in sf.nodes(ast.ImportFrom):
        for a in node.names:
            table[a.asname or a.name] = a.name
    return table


@_register(
    "overlap-unchunked-collective", "overlap-ok",
    "full-width collective (psum, psum_scatter, unshard) inside a staged "
    "overlap body (re-serializes the transfer the S-stage pipeline "
    "exists to hide)",
    _overlap_bodies,
)
def _check_overlap(sf: SourceFile):
    local = _local_names(sf)
    for call in sf.nodes(ast.Call):
        name = _name_of(call.func)
        if isinstance(call.func, ast.Name):
            name = local.get(name, name)
        if name in _FULL_WIDTH:
            yield call, (
                f"un-chunked {name}() in an overlap schedule body: stage the "
                "collective (1/S of the bytes per issue) or mark a "
                "deliberate chunked use"
            )


# "open" in the attribute set covers Path.open()-style method calls.
_IO_ATTRS = ("open", "write", "write_text", "write_bytes")
_IO_CALLS = ("open", "io.open", "json.dump", "torch.save")


@_register(
    "hot-path-blocking-io", "obs-ok",
    "blocking file I/O on the engine dispatch hot path (file writes go "
    "through the obs sink thread)",
    _hot_path,
)
def _check_blocking_io(sf: SourceFile):
    for call in sf.nodes(ast.Call):
        fn = call.func
        q = sf.qualname(fn) or ""
        if q in _IO_CALLS:
            yield call, (
                f"{q}() blocks on the filesystem; route writes through "
                "obs/sink.py (the sink thread) or mark a non-hot-path "
                "write"
            )
        elif isinstance(fn, ast.Attribute) and fn.attr in _IO_ATTRS:
            yield call, (
                f".{fn.attr}() blocks on the filesystem; route writes "
                "through obs/sink.py (the sink thread) or mark a "
                "non-hot-path write"
            )


_F64_NAMES = ("torch.float64", "torch.double")
# Host constructors whose dtype defaults to float64 for float input.
_NP_DTYPELESS_CTORS = (
    "numpy.asarray", "numpy.array", "numpy.zeros", "numpy.ones",
    "numpy.empty", "numpy.full",
)


def _is_f64(sf: SourceFile, node: ast.AST) -> bool:
    return (sf.qualname(node) or "") in _F64_NAMES


def _dtypeless_numpy(sf: SourceFile, node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and (sf.qualname(node.func) or "") in _NP_DTYPELESS_CTORS
        and not any(kw.arg == "dtype" for kw in node.keywords)
        and len(node.args) < 2
    )


@_register(
    "fp64-implicit-promotion", "fp64-ok",
    "unstated float64 reaching torch: dtype=float, torch.float64 as a "
    "dtype, .double(), or torch.from_numpy/as_tensor of a dtype-less "
    "numpy array on the dispatch path",
    _package,
)
def _check_fp64(sf: SourceFile):
    on_path = _on_dispatch_path(sf.rel)
    for call in sf.nodes(ast.Call):
        fn = call.func
        q = sf.qualname(fn) or ""
        for kw in call.keywords:
            if kw.arg != "dtype":
                continue
            if sf.qualname(kw.value) == "float":
                yield call, (
                    "dtype=float is float64; name the width explicitly"
                )
            elif _is_f64(sf, kw.value):
                yield call, (
                    f"dtype={ast.unparse(kw.value)} makes a float64 tensor; "
                    "in a bf16/fp32 pipeline it promotes every later op "
                    "(use the operand's dtype, or mark a deliberate fp64 "
                    "tier)"
                )
        if isinstance(fn, ast.Attribute) and fn.attr == "to" and any(
            _is_f64(sf, arg) for arg in call.args
        ):
            yield call, (
                ".to(float64) widens to float64 (mark the deliberate fp64 "
                "tier or oracle)"
            )
        elif isinstance(fn, ast.Attribute) and fn.attr == "double" \
                and not call.args:
            yield call, ".double() widens to float64 (mark a deliberate one)"
        if on_path and q in ("torch.from_numpy", "torch.as_tensor"):
            if q == "torch.as_tensor" and any(
                kw.arg == "dtype" for kw in call.keywords
            ):
                continue
            if call.args and (
                q == "torch.as_tensor" or _dtypeless_numpy(sf, call.args[0])
            ):
                yield call, (
                    f"{q}() of an array whose dtype nothing states: a "
                    "float numpy array is float64 by default and promotes "
                    "the served program (state the dtype)"
                )


# Tensor constructors, a CUDA call or a kernel build at import time
# initialize the device (or build kernels) before any caller chose one.
_TORCH_CTORS = frozenset({
    "tensor", "as_tensor", "from_numpy", "zeros", "ones", "empty", "full",
    "arange", "linspace", "eye", "rand", "randn", "randint", "zeros_like",
    "ones_like", "empty_like", "full_like",
})
_BUILD_CALLS = ("load_library", "ensure_built", "load", "load_inline")


@_register(
    "import-time-torch", "import-ok",
    "tensor creation, a torch.cuda call or a kernel build executed at "
    "module import time (initializes a device before any caller chose "
    "one)",
    _port_programs,
)
def _check_import_time_torch(sf: SourceFile):
    for top in _import_time_nodes(sf.tree):
        if not isinstance(top, ast.Call):
            continue
        q = sf.qualname(top.func) or ""
        name = _name_of(top.func)
        if q.startswith("torch.cuda."):
            yield top, (
                f"{q}() runs at import time — it initializes CUDA before "
                "any caller chose a device; call it inside the function "
                "that needs it"
            )
        elif q.startswith("torch.") and q.split(".")[-1] in _TORCH_CTORS \
                and q.count(".") == 1:
            yield top, (
                f"{q}() makes a tensor at import time; compute it lazily "
                "(or with numpy)"
            )
        elif name in _BUILD_CALLS and (
            "_build" in q or "cpp_extension" in q or "native_lib" in q
            or q in ("load_library", "ensure_built")
        ):
            yield top, (
                f"{q}() builds or loads a kernel at import time; build it "
                "inside the function that launches it"
            )


_MUTABLE_FACTORIES = (
    "list", "dict", "set", "collections.defaultdict", "collections.deque",
)


@_register(
    "mutable-default-arg", "default-ok",
    "mutable default argument (shared across every call)",
    _package,
)
def _check_mutable_default(sf: SourceFile):
    for node in sf.nodes(
        ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda
    ):
        for default in _defaults(node.args):
            if isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(default, ast.Call)
                and sf.qualname(default.func) in _MUTABLE_FACTORIES
            ):
                yield default, (
                    "mutable default argument is evaluated once and shared "
                    "across every call; default to None and construct "
                    "inside the body"
                )


def _scheduler(rel: str) -> bool:
    return rel == f"{_PKG}/engine/scheduler.py"


# Calls that enter the engine's dispatch path (or block draining it).
# Holding the scheduler's admission lock across any of these turns a
# backpressure stall into a total admission freeze.
_DISPATCH_CALLS = ("submit", "warmup", "block_until_ready", "synchronize")
# Context-manager name fragments that mark a lock (Lock, RLock, Condition).
_LOCKISH = ("lock", "cond", "mutex")


def _lockish_with(node: ast.With) -> bool:
    for item in node.items:
        for sub in ast.walk(item.context_expr):
            name = _name_of(sub)
            if name is not None and any(
                frag in name.lower() for frag in _LOCKISH
            ):
                return True
    return False


def _walk_excluding_deferred(nodes: Iterable[ast.AST]) -> Iterator[ast.AST]:
    """Walk statements executed *inside* a with-block, skipping function
    and lambda bodies (deferred — they run under whatever lock state
    exists at call time, not this one)."""
    stack: list[ast.AST] = list(nodes)
    while stack:
        node = stack.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


@_register(
    "scheduler-lock-across-dispatch", "lock-ok",
    "engine dispatch (or blocking drain) entered while holding a "
    "scheduler lock: swap the batch out under the lock, dispatch after "
    "releasing it",
    _scheduler,
)
def _check_lock_across_dispatch(sf: SourceFile):
    for node in sf.nodes(ast.With):
        if not _lockish_with(node):
            continue
        for inner in _walk_excluding_deferred(node.body):
            if not isinstance(inner, ast.Call):
                continue
            attr = _name_of(inner.func)
            if attr in _DISPATCH_CALLS:
                yield inner, (
                    f"{attr}() under a held scheduler lock: an engine "
                    "dispatch can block in the backpressure drain, and a "
                    "blocked flush must not freeze admission — take the "
                    "batch out under the lock and dispatch after "
                    "releasing it"
                )


# A broad handler is "silent" unless its body re-raises, calls something
# that records the failure (a counter, a future's failure, a collection
# it parks the error in, a log call), or binds the exception to an
# error-ish name. A handler that does none of these has made an exception
# disappear, which in a serving system turns faults into wrong answers.
_RECORDING_CALLS = frozenset({
    "inc", "observe", "append", "put", "fail", "_fail", "set_exception",
    "record", "record_failure", "warning", "error", "exception",
})
_ERRORISH_NAME_FRAGMENTS = ("error", "exc", "failure", "fault")
_BROAD_EXCEPTIONS = ("Exception", "BaseException")


def _handler_is_broad(sf: SourceFile, handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True  # bare except:
    types = (
        handler.type.elts if isinstance(handler.type, ast.Tuple)
        else [handler.type]
    )
    return any((sf.qualname(t) or "") in _BROAD_EXCEPTIONS for t in types)


def _handler_records(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = _name_of(node.func)
            if name is not None and name in _RECORDING_CALLS:
                return True
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for target in targets:
                name = _name_of(target)
                if name is not None and any(
                    frag in name.lower() for frag in _ERRORISH_NAME_FRAGMENTS
                ):
                    return True
    return False


@_register(
    "silent-except", "swallow-ok",
    "broad `except Exception`/bare except that neither re-raises, records "
    "the failure (counter/future/error variable), nor carries a "
    "justification marker",
    _package,
)
def _check_silent_except(sf: SourceFile):
    for node in sf.nodes(ast.ExceptHandler):
        if not _handler_is_broad(sf, node) or _handler_records(node):
            continue
        yield node, (
            "broad except block swallows the failure: re-raise, record it "
            "(obs counter, future._fail, an error variable), or mark the "
            "deliberate swallow with '# swallow-ok: <reason>'"
        )


# The quantized-storage helpers: scale math runs in torch (and host
# numpy), where float64 is one cast away; a float64 scale plane doubles the
# bytes the format's ratio assumes are fp32 and lies about the error budget
# the scales define. The deliberate exceptions (the quantizer widens rows
# to float64 so the int8c residual is the true quantization error, then
# stores fp32) carry the marker.


def _quant_scope(rel: str) -> bool:
    return rel in (f"{_PKG}/ops/quantize.py", f"{_PKG}/ops/cuda_quant.py")


_QUANT_F64_NAMES = _F64_NAMES + ("numpy.float64", "jax.numpy.float64", "float")


def _is_quant_f64(sf: SourceFile, node: ast.AST) -> bool:
    if (sf.qualname(node) or "") in _QUANT_F64_NAMES:
        return True
    return isinstance(node, ast.Constant) and node.value == "float64"


@_register(
    "quant-fp64-scale", "quant-ok",
    "float64 in quantization scale math (astype/.to/dtype to f64, or a "
    "dtype-less host constructor defaulting to it) — scales are fp32 by "
    "doctrine",
    _quant_scope,
)
def _check_quant_fp64(sf: SourceFile):
    for call in sf.nodes(ast.Call):
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in ("astype", "to") \
                and any(_is_quant_f64(sf, arg) for arg in call.args):
            yield call, (
                f".{fn.attr}(float64) in the quant scope: scales and staged "
                "values are fp32 by doctrine (mark the deliberate "
                "exception with '# quant-ok: <reason>')"
            )
            continue
        for kw in call.keywords:
            if kw.arg == "dtype" and _is_quant_f64(sf, kw.value):
                yield call, (
                    "dtype=float64 in the quant scope: scales are fp32 by "
                    "doctrine"
                )
        q = sf.qualname(fn) or ""
        if q in _NP_DTYPELESS_CTORS and not any(
            kw.arg == "dtype" for kw in call.keywords
        ):
            yield call, (
                f"{q}() without a dtype in the quant scope defaults "
                "to float64 for float input; name the width (or mark "
                "a deliberate dtype passthrough)"
            )


# The multi-tenant registry's lock discipline: the registry mutex
# serializes admission bookkeeping for every tenant, so holding it across
# a placement (the swap-in), a dispatch (submit/warmup can build or block
# in the backpressure drain) or a host sync turns one tenant's swap into a
# fleet-wide admission freeze. Victim RELEASE under the lock is legal by
# design (dropping references moves nothing). The JAX package's names stay
# in the set, so its fixture reads the same here.
_REGISTRY_LOCK_CALLS = (
    "device_put", "device_get", "block_until_ready", "ensure_resident",
    "submit", "warmup", "shard", "shard_operand", "synchronize",
)


@_register(
    "device-transfer-under-registry-lock", "registry-ok",
    "placement (shard/ensure_resident), dispatch (submit/warmup) or host "
    "sync entered while holding a registry/residency mutex: plan under "
    "the lock, place and dispatch after releasing it",
    _engine,
)
def _check_registry_lock(sf: SourceFile):
    for node in sf.nodes(ast.With):
        if not _lockish_with(node):
            continue
        for inner in _walk_excluding_deferred(node.body):
            if not isinstance(inner, ast.Call):
                continue
            attr = _name_of(inner.func)
            if attr in _REGISTRY_LOCK_CALLS:
                yield inner, (
                    f"{attr}() under a held registry/residency mutex: a "
                    "placement or dispatch here freezes every tenant's "
                    "admission behind one tenant's swap — plan victims "
                    "under the lock, place/dispatch after releasing it"
                )


# The global scheduler's admission doctrine: every submit-time decision
# CONSULTS the calibrated cost model, it never MEASURES. A measurement in
# the admission path puts a benchmark (and its host sync) in front of
# every request; a sleep stalls every later arrival. Reading the
# injectable monotonic clock is a read, not a measurement.


def _admission_scope(rel: str) -> bool:
    return rel == f"{_PKG}/engine/global_scheduler.py"


_MEASUREMENT_CALLS = (
    "perf_counter", "process_time", "timeit",
    "time_matvec", "benchmark_strategy", "benchmark_gemm", "calibrate",
    "_measure_fn", "block_until_ready", "sleep", "synchronize",
    "elapsed_time",
)


@_register(
    "measurement-in-admission-path", "admit-ok",
    "timing/measurement machinery in the global scheduler's admission "
    "path (admission consults predictions; it never times a dispatch)",
    _admission_scope,
)
def _check_admission_measurement(sf: SourceFile):
    for call in sf.nodes(ast.Call):
        attr = _name_of(call.func)
        if attr in _MEASUREMENT_CALLS:
            yield call, (
                f"{attr}() in the admission path: admission consults the "
                "calibrated cost model and never measures — timing a "
                "dispatch here puts a benchmark (and its host sync) in "
                "front of every request (move it to the tuner/bench, or "
                "mark a deliberate exception with '# admit-ok: <reason>')"
            )


# Metric-series cardinality: the registry stores labeled metrics under
# their full labeled name, so every dynamically built name is a new series
# for the process's lifetime. Building one per loop iteration leaks series
# without bound. Dynamic names are legal where the label source is bounded
# (tenant ids capped by the registered fleet, declared SLO targets); those
# sites carry the cardinality marker with the bound as its reason.

_METRIC_CTORS = ("counter", "gauge", "histogram", "rate_estimator",
                 "ewma_gauge")

_LOOP_NODES = (ast.For, ast.AsyncFor, ast.While, ast.ListComp,
               ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _is_constructed_name(node: ast.AST) -> bool:
    """A metric-name expression assembled at the call site: f-string,
    string concat/%-format, ``.format()``, or a ``label(...)`` call."""
    if isinstance(node, ast.JoinedStr):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.Add, ast.Mod)
    ):
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "format":
            return True
        if _name_of(fn) == "label":
            return True
    return False


@_register(
    "metric-label-cardinality", "cardinality-ok",
    "labeled/dynamic metric name constructed inside a loop or "
    "comprehension: each distinct name is a live series forever, so a "
    "per-iteration name with an unbounded label source leaks series "
    "without bound",
    _package,
)
def _check_metric_cardinality(sf: SourceFile):
    seen: set[int] = set()
    for loop in sf.nodes(*_LOOP_NODES):
        for call in _calls(loop):
            if id(call) in seen:
                continue
            fn = call.func
            attr = fn.attr if isinstance(fn, ast.Attribute) else None
            if attr not in _METRIC_CTORS or not call.args:
                continue
            if not _is_constructed_name(call.args[0]):
                continue
            seen.add(id(call))
            yield call, (
                f"{attr}() with a name built per loop iteration: every "
                "distinct name is a new live series (the registry never "
                "drops one), so an unbounded label source here leaks "
                "memory and floods the snapshot — hoist the series, "
                "bound the source, or mark the bounded case with "
                "'# cardinality-ok: <reason>'"
            )


# Rules #13-#15: the whole-program lock-graph auditor, and rules #17-#20:
# the value-flow engine (dataflow.py), register through the same decorator,
# so markers, fixtures and the CLI inherit; registration precedes the
# MARKERS snapshot below.
register_lockgraph_rules(_register)
register_dataflow_rules(_register)

MARKERS: dict[str, str] = _markers()

# Canonical one-line scope descriptions keyed by scope-predicate name: the
# vocabulary of README.md's rule table (a test holds the two equal).
_SCOPE_LABELS: dict[str, str] = {
    "_port_programs": "package + chip_smoke.py",
    "_engine": "engine/",
    "_overlap_bodies": "parallel/ring.py, ops/collective.py",
    "_hot_path": "engine/ + obs/ (minus sink, CLI)",
    "_package": "package",
    "_scheduler": "engine/scheduler.py",
    "_quant_scope": "ops/quantize.py, ops/cuda_quant.py",
    "_admission_scope": "engine/global_scheduler.py",
    "lockgraph_scope": "engine/, obs/, resilience/, tuning/",
    "dataflow_scope": "package",
    "sync_scope": "engine/, solvers/",
}


def scope_label(name: str) -> str:
    """The canonical scope string for one rule (the README table's)."""
    return _SCOPE_LABELS[get_rule(name).scope.__name__]
