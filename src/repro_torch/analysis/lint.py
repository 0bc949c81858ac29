"""AST lint over ``src/repro_torch``: the analyzer's source-scope pass
(port of ``repro/analysis/lint.py``).

Three rules, each a package-wide convention the op-record passes cannot
see:

* **bare-assert** — ``assert`` in library code vanishes under
  ``python -O``, silently skipping validation; library checks raise
  typed errors with messages.  (Tests are not linted — pytest asserts
  are the point there.)
* **algorithm-branch** — ``fl.algorithm == "..."`` (or literal-tuple
  membership) outside the plugin packages bypasses the
  ``repro_torch.fl.api`` registry; new mechanisms come in through
  ``register_algorithm``, not core branches.  Comparisons against a
  NAME (e.g. ``algorithm not in ALGORITHM_NAMES`` registry validation)
  are fine.
* **local-import** — function-local imports of anything but
  ``repro_torch`` / ``torch`` modules: the deliberate lazy imports break
  import cycles or defer heavy deps, and those are all repro_torch /
  torch; a stray local ``import os`` is just a hidden module dependency.

The allowlist (``"relpath"`` or ``"relpath:lineno"`` strings) exists as
a mechanism for incremental adoption — it ships EMPTY, and the port's
tests pin that it stays empty.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator, List, Sequence, Tuple

from repro_torch.analysis.registry import AnalysisPass, Finding, register_pass

# packages whose modules ARE the algorithm plugins — string dispatch on
# the algorithm name is their job (mirrors tests/test_api.py's old grep
# gate exclusions)
PLUGIN_PREFIXES = (os.path.join("fl", "api") + os.sep,
                   "contrib" + os.sep)

# import roots that may be deferred into function bodies (lazy
# cycle-breaking / optional heavy deps)
ALLOWED_LOCAL_IMPORT_ROOTS = ("repro_torch", "torch")

ALLOWLIST: Tuple[str, ...] = ()   # stays empty; see module docstring


def src_root() -> str:
    """The ``src/repro_torch`` directory this module was imported from."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iter_source_files(root=None) -> Iterator[Tuple[str, str]]:
    """``(relpath, abspath)`` of every python file under ``root``
    (default ``src/repro_torch``)."""
    root = root or src_root()
    for dirpath, _, files in sorted(os.walk(root)):
        for fname in sorted(files):
            if fname.endswith(".py"):
                path = os.path.join(dirpath, fname)
                yield os.path.relpath(path, root), path


def _is_algo_name(node: ast.AST) -> bool:
    return ((isinstance(node, ast.Attribute) and node.attr == "algorithm")
            or (isinstance(node, ast.Name) and node.id == "algorithm"))


def _literal_strings(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return all(isinstance(e, ast.Constant) and isinstance(e.value, str)
                   for e in node.elts)
    return False


def _algorithm_branches(tree: ast.AST) -> Iterator[ast.Compare]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        if not any(_is_algo_name(s) for s in sides):
            continue
        for op, right in zip(node.ops, node.comparators):
            if isinstance(op, (ast.Eq, ast.NotEq)) and (
                    _literal_strings(right) or _literal_strings(node.left)):
                yield node
                break
            if isinstance(op, (ast.In, ast.NotIn)) \
                    and _literal_strings(right):
                yield node
                break


def _local_imports(tree: ast.AST) -> Iterator[Tuple[ast.stmt, str]]:
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    root = alias.name.split(".")[0]
                    if root not in ALLOWED_LOCAL_IMPORT_ROOTS:
                        yield node, alias.name
            elif isinstance(node, ast.ImportFrom):
                root = (node.module or "").split(".")[0]
                if not node.level \
                        and root not in ALLOWED_LOCAL_IMPORT_ROOTS:
                    yield node, node.module or "."


@register_pass
class SourceLintPass(AnalysisPass):
    name = "source-lint"
    scope = "source"
    description = ("bare asserts, registry-bypassing algorithm branches "
                   "and non-repro_torch/torch function-local imports in "
                   "src/repro_torch")

    def __init__(self, root=None, allowlist: Sequence[str] = ALLOWLIST):
        self.root = root or src_root()
        self.allowlist = tuple(allowlist)

    def _allowed(self, rel: str, lineno: int) -> bool:
        return rel in self.allowlist or f"{rel}:{lineno}" in self.allowlist

    def run(self, target=None) -> List[Finding]:
        out = []
        for rel, path in iter_source_files(self.root):
            with open(path) as f:
                try:
                    tree = ast.parse(f.read(), filename=path)
                except SyntaxError as e:
                    out.append(self.finding(f"{rel}:{e.lineno}",
                                            f"syntax error: {e.msg}"))
                    continue
            for node in ast.walk(tree):
                if isinstance(node, ast.Assert) \
                        and not self._allowed(rel, node.lineno):
                    out.append(self.finding(
                        f"{rel}:{node.lineno}",
                        "bare assert in library code (skipped under "
                        "python -O); raise a typed error with a message"))
            if not rel.startswith(PLUGIN_PREFIXES):
                for node in _algorithm_branches(tree):
                    if not self._allowed(rel, node.lineno):
                        out.append(self.finding(
                            f"{rel}:{node.lineno}",
                            "string branch on the algorithm name outside "
                            "the plugin packages; dispatch through the "
                            "repro_torch.fl.api registry"))
            for node, mod in _local_imports(tree):
                if not self._allowed(rel, node.lineno):
                    out.append(self.finding(
                        f"{rel}:{node.lineno}",
                        f"function-local import of {mod!r}; only lazy "
                        f"repro_torch/torch imports may live inside "
                        f"functions"))
        return out
