"""The five house-rule invariant checks.

Each check is named; a finding of check `<name>` is suppressed by a
`# lint: <name>-ok(<reason>)` pragma on the finding line (or the line
above). The catalog — see ARCHITECTURE.md "Static analysis &
sanitizers" for the full contract:

  block    blocking-under-lock: no socket/HTTP/RPC/fleet-dispatch/
           sleep/queue wait inside a `with <lock>:` body
  thread   contextvar-safe threading: raw threading.Thread /
           ThreadPoolExecutor outside FanOutPool/copy_context drops
           deadline budgets and trace ids silently
  swallow  `except Exception:` bodies must re-raise, classify, latch,
           log, or bump a counter — never vanish an error
  metric   metrics hygiene: family naming, no unbounded-cardinality
           labels, every dotted subsystem flag documented in README
  gate     zero-cost-gate discipline: no thread may spawn at import
           or construction time — threads start lazily behind seams

These are syntactic checks (no interprocedural analysis): a blocking
call hidden behind a helper function called under a lock is the
runtime sanitizer's job (`util/sanitizer.py`), not this one's.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from seaweedfs_tpu_torch.analysis.engine import Context, Source, check, dotted

# -- block: blocking-under-lock ----------------------------------------------

# final name segment that makes a with-item "a lock"
_LOCK_NAME = re.compile(r"(^|_)(lock|mutex)$|(^|_)cond$")

_SOCKETY = {"sendall", "recv", "recv_into", "accept", "getaddrinfo",
            "create_connection", "makefile"}
_SUBPROC = {"check_output", "check_call", "communicate"}
_QUEUEISH = re.compile(r"(^|_)q(ueue)?$|queue")
_THREADISH = re.compile(r"(^|_)t(h|hread)?s?$|thread|flapper|worker")


def _is_lock_expr(expr: ast.AST) -> Optional[str]:
    segs = dotted(expr)
    if segs and _LOCK_NAME.search(segs[-1]):
        return ".".join(segs)
    return None


def _blocking_reason(call: ast.Call, held: Set[str],
                     cv_bind: dict) -> Optional[str]:
    segs = dotted(call.func)
    if not segs:
        return None
    tail, recv = segs[-1], segs[:-1]
    last = recv[-1] if recv else ""
    if tail == "sleep":
        return "sleep()"
    if tail in _SOCKETY:
        return f"socket .{tail}()"
    if tail == "connect" and "sock" in last:
        return "socket .connect()"
    if tail == "request" and last in ("http_client", "requests"):
        return "HTTP request"
    if tail == "urlopen":
        return "HTTP urlopen"
    if tail in ("readline", "readinto", "read") and (
            last in ("rfile", "wfile") or "sock" in last):
        return f"socket file .{tail}()"
    if tail in ("get", "put") and last and _QUEUEISH.search(last):
        return f"queue .{tail}()"
    if tail == "wait":
        r = ".".join(recv)
        if r not in held and cv_bind.get(r) not in held:
            return ".wait() on a foreign synchronizer"
    if tail == "join" and last and _THREADISH.search(last):
        return "thread .join()"
    if tail == "run" and last.endswith("pool"):
        return "pool .run()"
    if tail in _SUBPROC or (last == "subprocess" and tail == "run"):
        return "subprocess"
    if tail.startswith("fleet_") or tail == "dispatch":
        return "fleet dispatch"
    if last in ("stub", "_stub") or tail in ("generic_call",
                                             "_resilient_call"):
        return "RPC call"
    return None


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
           ast.ClassDef)


def _condition_bindings(tree: ast.AST) -> dict:
    """{'self._commit_cv': 'self._lock'} for every
    `X = threading.Condition(Y)` in the module — waiting on a
    condition releases ITS lock, so cv.wait() while holding that same
    lock is the sanctioned sleep, not a blocking call."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Call):
            segs = dotted(node.value.func)
            if segs and segs[-1] == "Condition" and node.value.args:
                bound = dotted(node.value.args[0])
                for tgt in node.targets:
                    t = dotted(tgt)
                    if t and bound:
                        out[".".join(t)] = ".".join(bound)
    return out


@check("block")
def check_blocking_under_lock(ctx: Context) -> None:
    for src in ctx.sources:
        cv_bind = _condition_bindings(src.tree)
        _walk_block(ctx, src, src.tree, held=set(), cv_bind=cv_bind)


def _walk_block(ctx: Context, src: Source, node: ast.AST,
                held: Set[str], cv_bind: dict) -> None:
    for child in ast.iter_child_nodes(node):
        if isinstance(child, _SCOPES):
            # a def/lambda/class inside a lock body runs later, not
            # under the lock; restart with nothing held
            _walk_block(ctx, src, child, set(), cv_bind)
            continue
        if isinstance(child, ast.With):
            locks = [n for n in
                     (_is_lock_expr(i.context_expr)
                      for i in child.items) if n]
            if locks:
                inner = held | set(locks)
                for stmt in child.body:
                    if isinstance(stmt, _SCOPES):
                        # a def/class directly under the with runs
                        # later, not under the lock
                        _walk_block(ctx, src, stmt, set(), cv_bind)
                    else:
                        _walk_block(ctx, src, stmt, inner, cv_bind)
                # with-items themselves evaluated with outer locks only
                continue
        if held and isinstance(child, ast.Call):
            why = _blocking_reason(child, held, cv_bind)
            if why is not None:
                ctx.add(src, child.lineno, "block",
                        f"{why} while holding "
                        f"{'/'.join(sorted(held))}")
        _walk_block(ctx, src, child, held, cv_bind)


# -- thread: contextvar-safe threading ---------------------------------------


@check("thread")
def check_contextvar_threading(ctx: Context) -> None:
    for src in ctx.sources:
        if src.rel.endswith("util/fanout.py"):
            continue   # the sanctioned seam itself
        spawns = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                segs = dotted(node.func)
                if not segs:
                    continue
                tail = segs[-1]
                if tail == "Thread" and (len(segs) == 1
                                         or segs[-2] == "threading"):
                    spawns.append((node, "threading.Thread"))
                elif tail == "ThreadPoolExecutor":
                    spawns.append((node, "ThreadPoolExecutor"))
        if not spawns:
            continue
        # a function that copies context before handing work over is
        # doing the FanOutPool discipline by hand — accept it
        ctxsafe_lines = _copy_context_spans(src.tree)
        for node, what in spawns:
            if any(a <= node.lineno <= b for a, b in ctxsafe_lines):
                continue
            ctx.add(src, node.lineno, "thread",
                    f"raw {what} outside FanOutPool/copy_context "
                    "drops deadline budgets and trace ids")


def _copy_context_spans(tree: ast.AST) -> List[tuple]:
    spans = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    segs = dotted(sub.func)
                    if segs and segs[-1] == "copy_context":
                        spans.append((node.lineno,
                                      node.end_lineno or node.lineno))
                        break
    return spans


# -- swallow: silent broad excepts -------------------------------------------

_LOGGY = {"debug", "info", "warning", "warn", "error", "exception",
          "critical", "log", "print"}
_METRICY = {"inc", "dec", "observe", "set", "labels", "swallowed",
            "fail"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    for n in names:
        segs = dotted(n)
        if segs and segs[-1] in ("Exception", "BaseException"):
            return True
    return False


def _handles(handler: ast.ExceptHandler) -> bool:
    bound = handler.name
    for node in ast.walk(ast.Module(body=handler.body,
                                    type_ignores=[])):
        if isinstance(node, ast.Raise):
            return True
        if bound and isinstance(node, ast.Name) and node.id == bound:
            return True   # latched / classified / stringified
        if isinstance(node, ast.Call):
            segs = dotted(node.func)
            if not segs:
                continue
            tail = segs[-1]
            if tail in _LOGGY or tail in _METRICY or tail == "classify":
                return True
            if any("log" in s for s in segs[:-1]):
                return True
    return False


@check("swallow")
def check_swallowed_exceptions(ctx: Context) -> None:
    for src in ctx.sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _is_broad(node) and not _handles(node):
                ctx.add(src, node.lineno, "swallow",
                        "broad except swallows the error: re-raise, "
                        "classify, latch, log, or bump "
                        "SeaweedFS_swallowed_errors_total")


# -- metric: metrics hygiene --------------------------------------------------

_FAMILY_RE = re.compile(r"^SeaweedFS_[a-z0-9_]+$")
# label names whose value space grows with the data set, not the
# cluster: raw paths, fids, needle ids, keys, urls
_UNBOUNDED_LABELS = {"path", "fid", "file_id", "nid", "needle",
                     "needle_id", "key", "url"}


@check("metric")
def check_metrics_hygiene(ctx: Context) -> None:
    for src in ctx.sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            segs = dotted(node.func)
            if not segs or segs[-1] not in ("counter", "gauge",
                                            "histogram"):
                continue
            recv = segs[:-1]
            if not recv or "registry" not in recv[-1].lower():
                continue
            if not node.args or not isinstance(node.args[0],
                                               ast.Constant):
                continue
            family = node.args[0].value
            if not isinstance(family, str):
                continue
            if not _FAMILY_RE.match(family):
                ctx.add(src, node.lineno, "metric",
                        f"family '{family}' does not match "
                        "SeaweedFS_[a-z0-9_]+")
            for labels in list(node.args[1:]) + [
                    kw.value for kw in node.keywords
                    if kw.arg == "label_names"]:
                if isinstance(labels, (ast.Tuple, ast.List)):
                    for el in labels.elts:
                        if isinstance(el, ast.Constant) and \
                                str(el.value) in _UNBOUNDED_LABELS:
                            ctx.add(src, node.lineno, "metric",
                                    f"label '{el.value}' on {family} "
                                    "is unbounded-cardinality")
    _check_flag_docs(ctx)


def _check_flag_docs(ctx: Context) -> None:
    """Every dotted subsystem flag registered by the server CLIs must
    have a row in README's flag table (the zero-cost-gated knobs; -ip
    style basics are exempt)."""
    readme = ctx.repo_root / "README.md"
    if not readme.exists():
        return
    doc = readme.read_text(encoding="utf-8")
    for src in ctx.sources:
        if not src.rel.endswith(("command/servers.py",
                                 "command/benchmark.py")):
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            segs = dotted(node.func)
            if not segs or segs[-1] != "add_argument":
                continue
            if not node.args or not isinstance(node.args[0],
                                               ast.Constant):
                continue
            flag = node.args[0].value
            if not isinstance(flag, str) or "." not in flag or \
                    not flag.startswith("-"):
                continue
            if f"`{flag}`" not in doc:
                ctx.add(src, node.lineno, "metric",
                        f"flag {flag} missing from README's flag "
                        "table")


# -- gate: zero-cost-gate discipline -----------------------------------------


@check("gate")
def check_zero_cost_gates(ctx: Context) -> None:
    """No thread may spawn at import or construction time. A
    `threading.Thread(...)` built at module scope or inside __init__
    means constructing the object costs a thread even when the
    subsystem is disabled — the house rule is zero threads until first
    use, behind the module's flag seam."""
    for src in ctx.sources:
        _walk_gate(ctx, src, src.tree, where="<module>")


def _walk_gate(ctx: Context, src: Source, node: ast.AST,
               where: str) -> None:
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _walk_gate(ctx, src, child, where=child.name)
            continue
        if isinstance(child, ast.ClassDef):
            # a class BODY executes at import time, same as module scope
            _walk_gate(ctx, src, child, where="<class body>")
            continue
        if isinstance(child, ast.Call) and where in ("<module>",
                                                     "<class body>",
                                                     "__init__"):
            segs = dotted(child.func)
            if segs and segs[-1] == "Thread" and (
                    len(segs) == 1 or segs[-2] == "threading"):
                ctx.add(src, child.lineno, "gate",
                        f"Thread constructed in {where}: threads must "
                        "spawn lazily at first use behind the "
                        "subsystem's flag seam")
        _walk_gate(ctx, src, child, where)
