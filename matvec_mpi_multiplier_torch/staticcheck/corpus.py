"""Corpus discovery + per-file analysis context.

The port's corpus: the package ``matvec_mpi_multiplier_torch/``, the
port's tests (``tests/test_torch_*.py``) and ``chip_smoke.py``. The JAX
package's tree is the JAX package's own corpus and is never scanned here.
Each file is parsed
once into a :class:`SourceFile` carrying the AST, the real comment map
(via ``tokenize`` — so marker exemptions live in comments only, never in
strings), and an import-alias table that resolves attribute chains to
fully-qualified dotted names (``import torch.cuda as tc; tc.synchronize`` →
``torch.cuda.synchronize`` — no alias hides a call from a rule).
"""

from __future__ import annotations

import ast
import io
import tokenize
from pathlib import Path

SCAN_ROOTS = ("matvec_mpi_multiplier_torch",)
# Root-relative globs beside the package: the port's tests only.
SCAN_GLOBS = ("tests/test_torch_*.py",)
SCAN_FILES = ("chip_smoke.py",)


def repo_root() -> Path:
    """The checkout root: two levels above this package."""
    return Path(__file__).resolve().parents[2]


def iter_corpus(root: Path | None = None) -> list[Path]:
    """Every Python source the rules scan, sorted (missing roots skipped —
    an installed package may not ship tests/)."""
    root = Path(root) if root is not None else repo_root()
    paths: list[Path] = []
    for sub in SCAN_ROOTS:
        base = root / sub
        if base.is_dir():
            paths.extend(sorted(base.rglob("*.py")))
    for pattern in SCAN_GLOBS:
        paths.extend(sorted(root.glob(pattern)))
    for name in SCAN_FILES:
        p = root / name
        if p.is_file():
            paths.append(p)
    return paths


class SourceFile:
    """One parsed corpus file: AST + comments + import-alias resolution."""

    def __init__(self, path: Path, root: Path):
        self.path = Path(path)
        self.root = Path(root)
        self.rel = self.path.relative_to(self.root).as_posix()
        self.text = self.path.read_text()
        # May raise SyntaxError — run_rules turns that into a finding.
        self.tree = ast.parse(self.text, filename=str(self.path))
        self._comments: dict[int, str] | None = None
        self._aliases: dict[str, str] | None = None
        self._by_type: dict[type, list[ast.AST]] | None = None

    def nodes(self, *types: type) -> list[ast.AST]:
        """All nodes of the given AST types, from ONE cached full walk —
        the shared index flat rules iterate instead of each re-walking
        the tree (≈15 rules × every file adds up). Grouped by type, so
        relative source order holds within a type but not across types;
        every consumer filters by isinstance and sorts findings later."""
        if self._by_type is None:
            by: dict[type, list[ast.AST]] = {}
            for node in ast.walk(self.tree):
                by.setdefault(type(node), []).append(node)
            self._by_type = by
        if len(types) == 1:
            return self._by_type.get(types[0], [])
        out: list[ast.AST] = []
        for t in types:
            out.extend(self._by_type.get(t, ()))
        return out

    @property
    def comments(self) -> dict[int, str]:
        """{lineno: comment text without the leading '#'} — real comments
        only, so a marker inside a string literal exempts nothing."""
        if self._comments is None:
            found: dict[int, str] = {}
            try:
                for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline
                ):
                    if tok.type == tokenize.COMMENT:
                        found[tok.start[0]] = tok.string.lstrip("#").strip()
            except tokenize.TokenizeError:
                pass  # already surfaced as a parse finding
            self._comments = found
        return self._comments

    @property
    def aliases(self) -> dict[str, str]:
        """Local name → fully-qualified dotted module/object path, from
        every import statement in the file (module- and function-level)."""
        if self._aliases is None:
            table: dict[str, str] = {}
            for node in self.nodes(ast.Import, ast.ImportFrom):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        if a.asname:
                            table[a.asname] = a.name
                        else:
                            # `import torch.cuda` binds the top name "torch".
                            top = a.name.split(".", 1)[0]
                            table[top] = top
                elif isinstance(node, ast.ImportFrom) and node.module:
                    if node.level:
                        continue  # relative: never a torch/numpy/json target
                    for a in node.names:
                        table[a.asname or a.name] = f"{node.module}.{a.name}"
            self._aliases = table
        return self._aliases

    def qualname(self, node: ast.AST) -> str | None:
        """Resolve a Name/Attribute chain to its imported dotted path
        (``np.asarray`` → ``numpy.asarray``); bare un-imported names
        resolve to themselves (builtins like ``open``)."""
        if isinstance(node, ast.Name):
            return self.aliases.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            base = self.qualname(node.value)
            return f"{base}.{node.attr}" if base else None
        return None

    def span_comments(self, node: ast.AST) -> str:
        """All comment text on the physical lines a node spans — where a
        ``# <marker>: <reason>`` exemption may sit."""
        first = getattr(node, "lineno", 0)
        last = getattr(node, "end_lineno", first) or first
        return " ".join(
            self.comments[ln] for ln in range(first, last + 1)
            if ln in self.comments
        )


# One parse per file per run, shared by every analysis layer: the rule
# loop, the lock-graph auditor and the value-flow engine all consume the
# same corpus, and each used to re-parse it. Keyed by absolute path;
# validated by CONTENT, not mtime, so an edit between calls (the
# fixture/mutation tests do this) always invalidates.
_SF_CACHE: dict[str, SourceFile] = {}


def source_file(path: Path, root: Path) -> SourceFile:
    """The shared parsed view of ``path`` (see ``_SF_CACHE``). Raises
    ``SyntaxError``/``UnicodeDecodeError`` like the constructor; failed
    parses are never cached."""
    key = str(Path(path).resolve())
    text = Path(path).read_text()
    hit = _SF_CACHE.get(key)
    if hit is not None and hit.text == text and hit.root == Path(root):
        return hit
    sf = SourceFile(path, root)
    _SF_CACHE[key] = sf
    return sf
