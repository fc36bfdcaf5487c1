"""The `guard` check: Clang-style guarded-by thread-safety analysis.

The runtime sanitizer sees lock *ordering*; nothing in the tree
proves which shared state each lock actually protects — a race that
never deadlocks sails through. This check is the static half of that
proof, modeled on Clang's thread-safety annotations:

  annotation   `self._vols = {}   # guarded_by(self._lock)` on the
               attribute's assignment (trailing, or a comment-only
               line directly above) declares the contract: every
               access of `self._vols` anywhere in the class must
               happen with `self._lock` held. The second form
               `# guarded_by(self._lock, writes)` sanctions the
               tree's idiomatic GIL-atomic lock-free *reads* while
               still requiring the lock for every mutation — the
               "locked insert, bare dict lookup" pattern the heat
               tracker and lease cache live on. A module-level
               variant (`_registered = set()  # guarded_by(_reg_lock)`)
               covers module-global state.

  requires     `def _pop_locked(self):  # requires(self._lock)` marks
               a helper whose callers must hold the lock; its body is
               analyzed as if the lock were held. (The claim itself
               is trusted, exactly like Clang's REQUIRES.)

  inference    even without annotations, any `self._x` that is ever
               MUTATED inside `with self._lock:` in one method is
               flagged when read or written outside that lock in
               another method — the obvious case needs no opt-in.

"Holding the lock" is syntactic: the access sits inside a
`with <lock expr>:` body (or a `# requires(...)` method) naming the
same dotted expression. Mutation means assignment / del / augmented
assignment to the name, to a subscript of it, or to an attribute
reached through it, plus calls of known mutating methods
(.append/.add/.pop/.update/...). Accesses inside `__init__` and
inside `@property` getters are exempt (construction happens-before
publication; properties are the sanctioned lock-free status reads),
and so is module top-level code (imports are single-threaded).
Closures and lambdas defined inside a locked region are analyzed with
NOTHING held — they run later, usually on another thread, which is
exactly when the guard matters.

Benign spots carry the standard mandatory-reason pragma:
`# lint: guard-ok(<why this race is safe>)`.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from seaweedfs_tpu_torch.analysis.engine import Context, Source, check, dotted

GUARD_RE = re.compile(
    r"#\s*guarded_by\(\s*([A-Za-z_][\w.]*)\s*(?:,\s*(writes|all)\s*)?\)")
REQ_RE = re.compile(r"#\s*requires\(\s*([A-Za-z_][\w.,\s]*?)\s*\)")

# a with-item whose dotted name matches this is a lock for INFERENCE
# (annotations may name anything; inference only trusts lock-looking
# names so `with self._file:` never fabricates a guard)
_LOCK_NAME = re.compile(r"(^|_)(lock|mutex)$|(^|_)cond$")

# method calls that mutate their receiver: enough to recognize every
# container-write idiom the tree uses (dict/list/set/deque)
_MUTATORS = {
    "append", "appendleft", "add", "clear", "discard", "extend",
    "insert", "pop", "popleft", "popitem", "remove", "setdefault",
    "update", "sort",
}

# constructors whose product is itself a synchronizer — never tracked
# as guarded data
_SYNC_CTORS = {"Lock", "RLock", "Condition", "Event", "Semaphore",
               "BoundedSemaphore", "Barrier"}


@dataclass
class _Guard:
    lock: str
    mode: str           # "all" | "writes"
    line: int
    used: bool = False


@dataclass
class _Access:
    attr: str
    line: int
    write: bool
    method: str
    held: FrozenSet[str]
    exempt: bool


@dataclass
class _ClassInfo:
    name: str
    line: int
    guards: Dict[str, _Guard] = field(default_factory=dict)
    accesses: List[_Access] = field(default_factory=list)
    sync_attrs: Set[str] = field(default_factory=set)


def _is_lockish(name: str) -> bool:
    return bool(_LOCK_NAME.search(name.rsplit(".", 1)[-1]))


def _comment_for(src: Source, stmt: ast.stmt) -> List[Tuple[int, str]]:
    """(line, text) comments that bind to `stmt`: trailing on its
    first or last line, or a comment-only line directly above."""
    out = []
    above = src.comments.get(stmt.lineno - 1)
    if above is not None and above[1]:
        out.append((stmt.lineno - 1, above[0]))
    for ln in sorted({stmt.lineno, stmt.end_lineno or stmt.lineno}):
        trailing = src.comments.get(ln)
        if trailing is not None:
            out.append((ln, trailing[0]))
    return out


def _requires_locks(src: Source, fn: ast.AST,
                    consumed: Set[int]) -> Set[str]:
    """requires() binds to the SIGNATURE region only: the comment-only
    line above the def, and trailing comments from the `def` line down
    to the line before the first body statement (multi-line
    signatures). Binding through end_lineno — as annotations on
    assignments do — would let a stray per-statement requires on the
    method's LAST line silently exempt the whole body."""
    locks: Set[str] = set()
    body = getattr(fn, "body", None)
    sig_end = body[0].lineno - 1 if body else fn.lineno
    candidates = []
    above = src.comments.get(fn.lineno - 1)
    if above is not None and above[1]:
        candidates.append((fn.lineno - 1, above[0]))
    for ln in range(fn.lineno, sig_end + 1):
        trailing = src.comments.get(ln)
        if trailing is not None:
            candidates.append((ln, trailing[0]))
    for line, text in candidates:
        for m in REQ_RE.finditer(text):
            consumed.add(line)
            for part in m.group(1).split(","):
                part = part.strip()
                if part:
                    locks.add(part)
    return locks


def _is_property(fn: ast.AST) -> bool:
    for deco in getattr(fn, "decorator_list", ()):
        segs = dotted(deco)
        if segs and segs[-1] in ("property", "cached_property"):
            return True
    return False


def _attr_of_self(node: ast.AST) -> Optional[str]:
    """'_vols' for any expression rooted at `self.<attr>...` — the
    outermost attribute is the tracked slot (mutating `self._a.b` or
    `self._a[k]` mutates state reached through `_a`)."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self":
            return node.attr
        node = node.value
    return None


def _name_base(node: ast.AST) -> Optional[str]:
    """Module-level variant of _attr_of_self: the root plain Name of
    a Name/Subscript/Attribute chain (None for self-rooted chains)."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    if isinstance(node, ast.Name) and node.id != "self":
        return node.id
    return None


def _sync_ctor(value: ast.AST) -> bool:
    if isinstance(value, ast.Call):
        segs = dotted(value.func)
        return bool(segs) and segs[-1] in _SYNC_CTORS
    return False


# -- per-function access walker ----------------------------------------------


class _FnWalker:
    """Walks one function body tracking the held-lock set; emits
    (attr-or-name, line, write, held) accesses for self attributes and
    module globals."""

    def __init__(self, src: Source, method: str, exempt: bool,
                 held: FrozenSet[str], module_names: Set[str],
                 local_names: Set[str],
                 sink_attr, sink_name):
        self.src = src
        self.method = method
        self.exempt = exempt
        self.module_names = module_names
        self.local_names = local_names
        self.sink_attr = sink_attr
        self.sink_name = sink_name
        self.held = held

    # -- emit helpers --

    def _emit(self, node: ast.AST, write: bool) -> None:
        attr = _attr_of_self(node)
        if attr is not None:
            self.sink_attr(_Access(attr, node.lineno, write,
                                   self.method, self.held, self.exempt))
            return
        base = _name_base(node)
        if base is not None and base in self.module_names and \
                base not in self.local_names:
            self.sink_name(_Access(base, node.lineno, write,
                                   self.method, self.held, self.exempt))

    def _emit_target(self, tgt: ast.AST) -> None:
        """Assignment target: the stored-to slot is a write; index
        expressions inside it are reads."""
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._emit_target(el)
            return
        if isinstance(tgt, ast.Starred):
            self._emit_target(tgt.value)
            return
        if isinstance(tgt, ast.Subscript):
            self._emit(tgt, write=True)
            self._visit_chain_rest(tgt)
            return
        if isinstance(tgt, (ast.Attribute, ast.Name)):
            self._emit(tgt, write=True)
            return
        self.visit(tgt)

    # -- the walk --

    def visit(self, node: ast.AST) -> None:
        meth = getattr(self, "visit_" + type(node).__name__, None)
        if meth is not None:
            meth(node)
            return
        for child in ast.iter_child_nodes(node):
            self.visit(child)

    def visit_body(self, stmts) -> None:
        for s in stmts:
            self.visit(s)

    def visit_With(self, node: ast.With) -> None:
        locks = []
        for item in node.items:
            segs = dotted(item.context_expr)
            if segs:
                locks.append(".".join(segs))
                # entering a context manager is an ACCESS to it: a
                # guarded attribute used as `with self._writer:` must
                # still honor its own guard (the held set gains the
                # name only for the BODY; lock-named attrs are never
                # tracked as data, so `with self._lock:` stays silent)
                self._emit(item.context_expr, write=False)
            else:
                self.visit(item.context_expr)
            if item.optional_vars is not None:
                self._emit_target(item.optional_vars)
        if locks:
            outer = self.held
            self.held = frozenset(outer | set(locks))
            self.visit_body(node.body)
            self.held = outer
        else:
            self.visit_body(node.body)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        for tgt in node.targets:
            self._emit_target(tgt)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
            self._emit_target(node.target)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.visit(node.value)
        # x += 1 reads and writes the slot; one write access covers it
        self._emit_target(node.target)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            self._emit_target(tgt)

    def visit_Call(self, node: ast.Call) -> None:
        # self._x.append(v) / _registered.add(v): receiver mutation
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS:
            self._emit(node.func.value, write=True)
            self._visit_chain_rest(node.func.value)
        else:
            self.visit(node.func)
        for a in node.args:
            self.visit(a)
        for kw in node.keywords:
            self.visit(kw.value)

    def _visit_chain_rest(self, node: ast.AST) -> None:
        """After _emit on a chain root, visit only the parts that are
        NOT the root slot itself (subscript indexes, call bases) so the
        same expression never reads as both a write and a read."""
        while isinstance(node, (ast.Subscript, ast.Attribute)):
            if isinstance(node, ast.Subscript):
                self.visit(node.slice)
            node = node.value
        if not isinstance(node, ast.Name):
            self.visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if _attr_of_self(node) is not None or \
                _name_base(node) is not None:
            # one access per trackable chain; still visit subscript
            # indexes inside it (they may be accesses of their own)
            self._emit(node, write=False)
            self._visit_chain_rest(node)
            return
        # chain bottoms at a call/complex expr (x.f().g): walk inner —
        # the inner call may itself be a tracked mutation
        for child in ast.iter_child_nodes(node):
            self.visit(child)

    def visit_Name(self, node: ast.Name) -> None:
        self._emit(node, write=False)

    def _nested(self, node: ast.AST) -> None:
        # a def/lambda under a lock runs LATER, with nothing held —
        # usually on another thread, which is when the guard matters
        outer, outer_locals = self.held, self.local_names
        self.held = frozenset()
        self.local_names = outer_locals | _local_names(node)
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.held, self.local_names = outer, outer_locals

    def visit_FunctionDef(self, node) -> None:
        self._nested(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._nested(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._nested(node)


def _bound_names(tgt: ast.AST) -> Set[str]:
    """Names BOUND by an assignment target: plain names (possibly
    inside tuple/list/starred unpacking). `x[k] = v` and `x.a = v`
    bind nothing — they mutate an existing object, so `x` must keep
    resolving to the module global it references."""
    if isinstance(tgt, ast.Name):
        return {tgt.id}
    if isinstance(tgt, (ast.Tuple, ast.List)):
        out: Set[str] = set()
        for el in tgt.elts:
            out.update(_bound_names(el))
        return out
    if isinstance(tgt, ast.Starred):
        return _bound_names(tgt.value)
    return set()


def _local_names(fn: ast.AST) -> Set[str]:
    """Names bound locally in `fn` (params, assignments, for targets,
    with-as, comprehension targets, imports) minus explicit globals —
    these shadow module globals and must not read as module accesses."""
    out: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (args.posonlyargs + args.args + args.kwonlyargs +
                  ([args.vararg] if args.vararg else []) +
                  ([args.kwarg] if args.kwarg else [])):
            out.add(a.arg)
    declared_global: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            declared_global.update(node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            tgts = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in tgts:
                out.update(_bound_names(t))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            out.update(_bound_names(node.target))
        elif isinstance(node, ast.comprehension):
            out.update(_bound_names(node.target))
        elif isinstance(node, ast.withitem) and \
                node.optional_vars is not None:
            out.update(_bound_names(node.optional_vars))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, ast.ExceptHandler) and node.name:
            out.add(node.name)
    return out - declared_global


# -- annotation collection ----------------------------------------------------


def _collect_guard(ctx: Context, src: Source, stmt: ast.stmt,
                   slot: str, guards: Dict[str, _Guard],
                   consumed: Set[int]) -> None:
    for line, text in _comment_for(src, stmt):
        m = GUARD_RE.search(text)
        if m is None:
            continue
        consumed.add(line)
        g = _Guard(m.group(1), m.group(2) or "all", stmt.lineno)
        prev = guards.get(slot)
        if prev is not None and (prev.lock, prev.mode) != (g.lock,
                                                           g.mode):
            ctx.add(src, stmt.lineno, "guard",
                    f"conflicting guarded_by for '{slot}': "
                    f"{prev.lock},{prev.mode} at line {prev.line} vs "
                    f"{g.lock},{g.mode}")
            continue
        if prev is None:
            guards[slot] = g


def _stmt_slot_class(stmt: ast.stmt) -> Optional[str]:
    """The self-attribute a method statement assigns (annotation
    anchor), if any."""
    tgts = []
    if isinstance(stmt, ast.Assign):
        tgts = stmt.targets
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        tgts = [stmt.target]
    for t in tgts:
        if isinstance(t, ast.Attribute) and \
                isinstance(t.value, ast.Name) and t.value.id == "self":
            return t.attr
    return None


def _stmt_slot_module(stmt: ast.stmt) -> Optional[str]:
    tgts = []
    if isinstance(stmt, ast.Assign):
        tgts = stmt.targets
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        tgts = [stmt.target]
    for t in tgts:
        if isinstance(t, ast.Name):
            return t.id
    return None


# -- the check ----------------------------------------------------------------


@check("guard")
def check_guarded_by(ctx: Context) -> None:
    for src in ctx.sources:
        _check_module(ctx, src)


def _check_module(ctx: Context, src: Source) -> None:
    module_names = {
        name for stmt in src.tree.body
        for name in [_stmt_slot_module(stmt)] if name is not None}
    mod_guards: Dict[str, _Guard] = {}
    mod_accesses: List[_Access] = []
    mod_sync: Set[str] = set()
    consumed: Set[int] = set()

    for stmt in src.tree.body:
        slot = _stmt_slot_module(stmt)
        if slot is not None:
            _collect_guard(ctx, src, stmt, slot, mod_guards, consumed)
            if isinstance(stmt, ast.Assign) and _sync_ctor(stmt.value):
                mod_sync.add(slot)

    # walk every function in the module for module-global accesses,
    # and every class for attribute accesses
    for node in src.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _walk_function(src, node, node.name, exempt=False,
                           module_names=module_names,
                           sink_attr=lambda a: None,
                           sink_name=mod_accesses.append,
                           consumed=consumed)
        elif isinstance(node, ast.ClassDef):
            _check_class(ctx, src, node, module_names, mod_accesses,
                         consumed)

    _enforce(ctx, src, mod_guards, mod_accesses, mod_sync,
             scope="module")

    # annotation hygiene: a guarded_by/requires comment that bound to
    # nothing is a trap — it reads as a contract but enforces nothing
    for line, (text, _own) in sorted(src.comments.items()):
        if line in consumed:
            continue
        if GUARD_RE.search(text):
            ctx.add(src, line, "guard",
                    "guarded_by annotation is not attached to an "
                    "assignment of the guarded attribute/global")
        elif REQ_RE.search(text) and "lint:" not in text:
            ctx.add(src, line, "guard",
                    "requires(<lock>) annotation is not attached to "
                    "a def")


def _walk_function(src: Source, fn, method: str, exempt: bool,
                   module_names: Set[str], sink_attr, sink_name,
                   consumed: Set[int]) -> None:
    held = frozenset(_requires_locks(src, fn, consumed))
    w = _FnWalker(src, method, exempt, held, module_names,
                  _local_names(fn), sink_attr, sink_name)
    w.visit_body(fn.body)


def _check_class(ctx: Context, src: Source, cls: ast.ClassDef,
                 module_names: Set[str], mod_accesses: List[_Access],
                 consumed: Set[int]) -> None:
    info = _ClassInfo(cls.name, cls.lineno)

    # class-body assignments can carry annotations too
    for stmt in cls.body:
        slot = _stmt_slot_module(stmt)   # bare names in a class body
        if slot is not None:
            _collect_guard(ctx, src, stmt, slot, info.guards, consumed)
            if isinstance(stmt, ast.Assign) and _sync_ctor(stmt.value):
                info.sync_attrs.add(slot)

    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef,
                                 ast.AsyncFunctionDef))]
    for m in methods:
        # collect annotations from assignment statements in the body
        for node in ast.walk(m):
            if isinstance(node, (ast.Assign, ast.AnnAssign,
                                 ast.AugAssign)):
                slot = _stmt_slot_class(node)
                if slot is not None:
                    _collect_guard(ctx, src, node, slot, info.guards,
                                   consumed)
                    if isinstance(node, ast.Assign) and \
                            _sync_ctor(node.value):
                        info.sync_attrs.add(slot)

    for m in methods:
        exempt = m.name == "__init__" or _is_property(m)
        _walk_function(src, m, m.name, exempt, module_names,
                       sink_attr=info.accesses.append,
                       sink_name=mod_accesses.append,
                       consumed=consumed)

    _enforce(ctx, src, info.guards, info.accesses, info.sync_attrs,
             scope=f"class {info.name}")


def _enforce(ctx: Context, src: Source, guards: Dict[str, _Guard],
             accesses: List[_Access], sync_attrs: Set[str],
             scope: str) -> None:
    by_attr: Dict[str, List[_Access]] = {}
    for a in accesses:
        by_attr.setdefault(a.attr, []).append(a)

    # annotated slots: the contract is explicit and class-wide
    for attr, g in guards.items():
        for a in by_attr.get(attr, ()):
            if a.exempt:
                continue
            if g.mode == "writes" and not a.write:
                continue
            if g.lock in a.held:
                continue
            kind = "write" if a.write else "read"
            ctx.add(src, a.line, "guard",
                    f"'{attr}' is guarded_by({g.lock}"
                    f"{', writes' if g.mode == 'writes' else ''}) but "
                    f"this {kind} in {a.method}() does not hold it")

    # inference for unannotated private slots: a mutation under a
    # lock-looking `with` establishes the guard; cross-method accesses
    # without it are findings
    for attr, accs in by_attr.items():
        if attr in guards or attr in sync_attrs or \
                not attr.startswith("_") or _is_lockish(attr):
            continue
        locked_writes = [a for a in accs
                         if a.write and not a.exempt and
                         any(_is_lockish(h) for h in a.held)]
        if not locked_writes:
            continue
        lock_sets = [frozenset(h for h in a.held if _is_lockish(h))
                     for a in locked_writes]
        common = frozenset.intersection(*lock_sets)
        if len({ls for ls in lock_sets}) > 1 and not common:
            continue   # mutations disagree on the lock: annotate it
        # the guard is the writers' COMMON lock set — an access holding
        # ANY member is correctly synchronized against every write
        # (demanding one specific member would flag reads that hold a
        # different shared guard)
        guard_set = common or lock_sets[0]
        writer_methods = {a.method for a in locked_writes}
        for a in accs:
            if a.exempt or (guard_set & a.held) or \
                    a.method in writer_methods:
                continue
            kind = "write" if a.write else "read"
            ctx.add(src, a.line, "guard",
                    f"'{attr}' is mutated under "
                    f"{'/'.join(sorted(guard_set))} in "
                    f"{'/'.join(sorted(writer_methods))}() — this "
                    f"unguarded {kind} in {a.method}() races it "
                    f"({scope}); hold the lock, annotate "
                    f"# guarded_by, or pragma with the reason")
