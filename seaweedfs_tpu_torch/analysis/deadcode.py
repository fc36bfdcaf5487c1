"""Pyflakes-equivalent dead-code sweep (check name: `dead`).

Four rules, tuned for zero false positives on this tree rather than
maximum recall (anything subtler belongs to a real linter):

  - unused imports (module + function scope); `__init__.py` files are
    exempt — imports there are the package's re-export surface
  - unused simple local assignments (`x = ...` never read; `_`-prefixed
    names and tuple/loop/with targets exempt by idiom)
  - f-strings with no placeholders (a plain string wearing an `f`)
  - unreachable statements after return/raise/break/continue

Suppress with `# lint: dead-ok(<reason>)` — e.g. a side-effect import.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from seaweedfs_tpu_torch.analysis.engine import Context, Source, check

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


@check("dead")
def check_dead_code(ctx: Context) -> None:
    for src in ctx.sources:
        _unused_imports(ctx, src)
        _unused_locals(ctx, src)
        _fstrings_and_unreachable(ctx, src)


def _used_names(tree: ast.AST) -> Set[str]:
    used: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(
                node.ctx, (ast.Load, ast.Del)):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            # catch the root of a.b.c even though the Name node below
            # it is also walked (cheap insurance)
            root = node
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value,
                                                           str):
            # quoted annotations / __all__ entries
            if node.value.isidentifier():
                used.add(node.value)
    return used


def _unused_imports(ctx: Context, src: Source) -> None:
    if src.rel.endswith("__init__.py"):
        return
    used = _used_names(src.tree)
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                bound = alias.asname or alias.name.split(".")[0]
                if bound not in used:
                    ctx.add(src, node.lineno, "dead",
                            f"unused import '{alias.asname or alias.name}'")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                bound = alias.asname or alias.name
                if bound not in used:
                    ctx.add(src, node.lineno, "dead",
                            f"unused import '{bound}' "
                            f"from {node.module}")


def _unused_locals(ctx: Context, src: Source) -> None:
    for node in ast.walk(src.tree):
        if not isinstance(node, _FUNCS):
            continue
        reads: Set[str] = set()
        declared_away: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and isinstance(
                    sub.ctx, (ast.Load, ast.Del)):
                reads.add(sub.id)
            elif isinstance(sub, (ast.Global, ast.Nonlocal)):
                declared_away.update(sub.names)
            elif isinstance(sub, ast.Constant) and isinstance(
                    sub.value, str) and sub.value.isidentifier():
                reads.add(sub.value)
        # assignments from THIS function's scope only — a nested def is
        # its own scope (walked separately) and a nested class body is
        # attribute definitions (protocol_version on a handler class is
        # read by the stdlib, not by any Name node here)
        assigns: Dict[str, int] = {}
        for sub in _own_scope(node):
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        assigns.setdefault(tgt.id, tgt.lineno)
            elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                if isinstance(sub.target, ast.Name):
                    assigns.setdefault(sub.target.id, sub.lineno)
        for name, lineno in sorted(assigns.items(),
                                   key=lambda kv: kv[1]):
            if name.startswith("_") or name in reads or \
                    name in declared_away:
                continue
            ctx.add(src, lineno, "dead",
                    f"local '{name}' assigned but never read")


def _own_scope(fn: ast.AST):
    """Nodes of a function body excluding nested def/class/lambda
    subtrees."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (*_FUNCS, ast.Lambda, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _fstrings_and_unreachable(ctx: Context, src: Source) -> None:
    # a FormattedValue's format_spec is itself a JoinedStr (":x" parses
    # to constants only) — never report those
    specs = {id(node.format_spec) for node in ast.walk(src.tree)
             if isinstance(node, ast.FormattedValue) and
             node.format_spec is not None}
    for node in ast.walk(src.tree):
        if isinstance(node, ast.JoinedStr) and id(node) not in specs:
            if not any(isinstance(v, ast.FormattedValue)
                       for v in node.values):
                ctx.add(src, node.lineno, "dead",
                        "f-string without placeholders")
        for body in _stmt_lists(node):
            for i, stmt in enumerate(body[:-1]):
                if isinstance(stmt, (ast.Return, ast.Raise, ast.Break,
                                     ast.Continue)):
                    ctx.add(src, body[i + 1].lineno, "dead",
                            "unreachable code after "
                            f"{type(stmt).__name__.lower()}")
                    break


def _stmt_lists(node: ast.AST) -> List[List[ast.stmt]]:
    out = []
    for attr in ("body", "orelse", "finalbody"):
        lst = getattr(node, attr, None)
        if isinstance(lst, list) and lst and isinstance(lst[0],
                                                        ast.stmt):
            out.append(lst)
    return out
