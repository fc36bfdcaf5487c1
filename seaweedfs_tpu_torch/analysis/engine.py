"""Analyzer engine: source walking, pragma parsing, findings.

The house-rules analyzer (see `seaweedfs_tpu_torch/analysis/__init__.py`)
is a set of AST checks that run over every module in the package. This
module is the shared substrate:

  - `Source`: one parsed file (text, lines, AST, pragmas)
  - `Finding`: one violation, keyed by check name + file + line
  - pragma parsing: `# lint: <check>-ok(<reason>)` comments suppress a
    finding of `<check>` on the same line or on the line directly
    below the pragma.  The reason is MANDATORY — an empty pragma is
    itself a finding — and stale pragmas (suppressing nothing) are
    findings too, so the allowlist can only shrink honestly.

Checks are registered with `@check("<name>")`; `run_checks()` walks
the package once and fans the parsed sources to every check.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

PACKAGE_ROOT = Path(__file__).resolve().parent.parent
REPO_ROOT = PACKAGE_ROOT.parent

# generated protobuf modules are not house-rules territory
_EXCLUDED = re.compile(r"_pb2(_grpc)?\.py$")

PRAGMA_RE = re.compile(r"#\s*lint:\s*([a-z][a-z-]*)-ok\(([^()]*)\)")


@dataclass(frozen=True)
class Finding:
    check: str
    path: str       # repo-relative, posix
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


@dataclass
class Pragma:
    key: str
    reason: str
    line: int
    own_line: bool = False   # comment-only line (nothing but the pragma)
    used: bool = False


class Source:
    """One parsed module: text, AST, and its lint pragmas."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=rel)
        self.pragmas: Dict[int, List[Pragma]] = {}
        # every comment, line -> (text, own_line) — the guard check
        # reads its `# guarded_by(...)` / `# requires(...)` grammar
        # out of this map
        self.comments: Dict[int, Tuple[str, bool]] = {}
        self._scan_pragmas()

    def _scan_pragmas(self) -> None:
        # tokenize so '# lint:' inside string literals never reads as
        # a pragma
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                row, col = tok.start
                own = not self.lines[row - 1][:col].strip() \
                    if row <= len(self.lines) else False
                self.comments[row] = (tok.string, own)
                for m in PRAGMA_RE.finditer(tok.string):
                    p = Pragma(m.group(1), m.group(2).strip(), row,
                               own_line=own)
                    self.pragmas.setdefault(row, []).append(p)
        except tokenize.TokenError:
            pass

    def allowed(self, key: str, line: int) -> bool:
        """True when a `# lint: <key>-ok(reason)` pragma covers `line`
        (same line, or a COMMENT-ONLY line directly above — a pragma
        trailing some other statement only covers its own line). Marks
        the pragma used so stale ones can be reported."""
        for cand in (line, line - 1):
            for p in self.pragmas.get(cand, ()):
                if p.key == key and p.reason and \
                        (cand == line or p.own_line):
                    p.used = True
                    return True
        return False


@dataclass
class Context:
    """Everything a check gets: the parsed sources plus repo paths
    (for cross-file rules like the README flag table)."""
    sources: List[Source]
    repo_root: Path
    findings: List[Finding] = field(default_factory=list)

    def add(self, src: Source, line: int, key: str, message: str) -> None:
        if not src.allowed(key, line):
            self.findings.append(Finding(key, src.rel, line, message))


_CHECKS: Dict[str, Callable[[Context], None]] = {}


def check(name: str) -> Callable:
    def deco(fn: Callable[[Context], None]) -> Callable[[Context], None]:
        _CHECKS[name] = fn
        return fn
    return deco


def check_names() -> Tuple[str, ...]:
    _load_checks()
    return tuple(sorted(_CHECKS))


def iter_sources(root: Optional[Path] = None) -> List[Source]:
    root = root or PACKAGE_ROOT
    out = []
    for p in sorted(root.rglob("*.py")):
        if _EXCLUDED.search(p.name) or "__pycache__" in p.parts:
            continue
        rel = p.relative_to(root.parent if root == PACKAGE_ROOT
                            else root).as_posix()
        out.append(Source(p, rel, p.read_text(encoding="utf-8")))
    return out


def _load_checks() -> None:
    # the check modules register themselves on import
    # lint: dead-ok(side-effect import registers the checks)
    from seaweedfs_tpu_torch.analysis import (  # noqa: F401
        deadcode, guards, invariants)


def run_checks(root: Optional[Path] = None,
               checks: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run every registered check over the package; returns findings
    sorted by file/line.  Includes pragma-hygiene findings: empty
    reasons and stale (never-matched) pragmas."""
    _load_checks()
    sources = iter_sources(root)
    ctx = Context(sources=sources, repo_root=REPO_ROOT)
    for name, fn in sorted(_CHECKS.items()):
        if checks is None or name in checks:
            fn(ctx)
    if checks is None:
        _pragma_hygiene(ctx)
    return sorted(ctx.findings, key=lambda f: (f.path, f.line, f.check))


def _pragma_hygiene(ctx: Context) -> None:
    known = set(_CHECKS)
    for src in ctx.sources:
        for plist in src.pragmas.values():
            for p in plist:
                if not p.reason:
                    ctx.findings.append(Finding(
                        "pragma", src.rel, p.line,
                        f"allowlist pragma '{p.key}-ok' needs a "
                        f"justification: # lint: {p.key}-ok(<why>)"))
                elif p.key not in known:
                    ctx.findings.append(Finding(
                        "pragma", src.rel, p.line,
                        f"unknown check '{p.key}' in lint pragma"))
                elif not p.used:
                    ctx.findings.append(Finding(
                        "pragma", src.rel, p.line,
                        f"stale pragma: no '{p.key}' finding here — "
                        "remove it"))


# -- shared AST helpers -------------------------------------------------------


def dotted(node: ast.AST) -> List[str]:
    """['a','b','c'] for a.b.c; [] when the expr isn't a plain dotted
    name (calls, subscripts)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []
