"""Concurrency static analysis over the repo's own Python.

A copy of ``paddle_tpu/analysis/concurrency.py`` (AST only; the import of
`diagnostics` rewired to the port's). The analysis package verifies the
Program IR at build time; this module turns the same discipline on the
*runtime*: in the port, the one-shot batcher (serve/batcher.py), the
decode engine and model registry (serve/), `AsyncFeeder`, `py_reader`'s
queue and double buffer (reader/), the tracer's ring (observe/) and the
executor's shared memo; in the JAX package also its HA planes. An AST
pass models every class: the threads it spawns
(`threading.Thread`/`Timer` targets, executor `.submit` callees, and the
intra-class call graph reachable from them), its lock attributes, and
its shared mutable fields. On top of that model it enforces three
properties, each surfaced as a ranked `Diagnostic` (diagnostics.py):

**Lock discipline** — a field annotated `# guarded_by: self._mu` on its
`__init__` assignment must be read and written with `self._mu` held.

    ``unguarded-write`` (ERROR)    write with no lock held
    ``unguarded-read``  (WARNING)  read with no lock held
    ``guard-mismatch``  (WARNING)  access under a *different* lock
    ``guard-inference`` (INFO)     majority-usage proposal for an
                                   unannotated cross-thread field

Unannotated fields that are demonstrably cross-thread (written in the
spawned-thread domain, touched outside it, or vice versa) get
majority-usage inference: if >= RATIO of their accesses happen under one
lock, that lock is proposed as the guard and the outlier accesses are
flagged at WARNING (never ERROR — the contract was inferred, not
declared).

**Deadlock cycles** — every acquisition taken while another lock is
held contributes an edge to a global acquires-while-holding graph whose
nodes are ``Class.lock`` (conditions normalize to the mutex they wrap).
Cross-class edges come from attribute types inferred from
``self.x = ClassName(...)`` in ``__init__``: holding my lock while
calling a method of a class that takes its own lock links the planes
(FleetRouter -> PSClient is exactly such an edge). A cycle — including
a self-cycle on a non-reentrant ``threading.Lock`` — is
``lock-order-cycle`` (ERROR).

**Hold-time hazards** — ``blocking-under-lock`` (WARNING): `time.sleep`,
socket/RPC primitives (`send_msg`, `recv_msg`, `connect`, `accept`,
...), `Condition.wait()` **without a timeout**, or `.join()` without a
timeout, executed while a lock is held that the call does not itself
release (a condition's own wait releases its wrapped mutex, so only
*additional* held locks count). Calls to intra-class or attribute-typed
methods that transitively block are flagged at the call site. On the
lease-renewal paths this is the lint that defends the ~0.7 s
failover-blip budget.

Held-lock state is tracked through ``with`` blocks, paired
``.acquire()``/``.release()`` statements, and *interprocedurally*: a
private method's entry held-set is the intersection of the held-sets at
every intra-class call site (public, dunder, and thread-root methods get
an implicit lock-free external caller). ``__init__`` is pre-publication
and exempt from discipline checks.

Suppression: a trailing ``# race_lint: ignore[code]`` (or a bare
``# race_lint: ignore``) on the flagged line, or
``# race_lint: skip-file`` anywhere in the first 10 lines of a module.
Nested function/lambda bodies execute on an unknowable thread at an
unknowable time and are skipped (documented limitation).

The JAX package's `tools/race_lint.py` is its CLI and
`tools/race_lint_baseline.json` its reviewed residue; the port's sweep
of itself, and its residue, live in tests/test_torch_analysis.py. Keys
(`baseline_key`) deliberately omit line numbers:
``code path Class.member detail`` survives unrelated edits to the file.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field as dc_field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .diagnostics import Diagnostic, Severity

__all__ = [
    "ConcurrencyDiagnostic", "analyze_source", "analyze_paths",
    "analyze_package", "baseline_key", "CODES",
]

CODES = ("unguarded-write", "unguarded-read", "guard-mismatch",
         "lock-order-cycle", "blocking-under-lock", "guard-inference")

# majority-usage inference: >= this fraction of a cross-thread field's
# accesses under one lock proposes that lock as the guard
_INFER_RATIO = 0.70
_INFER_MIN_SITES = 3

# lock-ish constructors (threading.*). Event is tracked for .wait()
# classification but is NOT a mutex — it never guards anything.
_MUTEX_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
                "BoundedSemaphore"}
_EVENT_CTORS = {"Event"}

# callables that block the calling thread for unbounded / network time.
# Names are matched on the called attribute (x.recv(...)) or the dotted
# tail of a module call (time.sleep, select.select). send_msg/recv_msg
# are the repo's own framed-RPC primitives (pserver/rpc.py, fleet/wire).
_BLOCKING_NAMES = frozenset({
    "sleep", "send_msg", "recv_msg", "sendall", "recv", "recvfrom",
    "accept", "connect", "create_connection", "getaddrinfo", "urlopen",
    "select",
})
# blocking only when called with NO timeout argument
_TIMEOUT_GATED = frozenset({"wait", "join", "result", "get"})

_GUARD_RE = re.compile(r"#\s*guarded_by:\s*(self\.\w+(?:\(\))?)")
_IGNORE_RE = re.compile(r"#\s*race_lint:\s*ignore(?:\[([\w\-,\s]+)\])?")
_SKIP_FILE_RE = re.compile(r"#\s*race_lint:\s*skip-file")


@dataclass
class ConcurrencyDiagnostic(Diagnostic):
    """A Diagnostic plus the stable provenance race_lint baselines on:
    (path, Class.member, detail) — no line numbers, so a key survives
    unrelated edits to the file."""

    path: str = ""        # repo-relative path
    qual: str = ""        # Class.field or Class.method
    detail: str = ""      # guard name / blocked call / cycle lock list
    line: int = 0


def baseline_key(d: ConcurrencyDiagnostic) -> str:
    return f"{d.code} {d.path} {d.qual} {d.detail}"


# ---------------------------------------------------------------------------
# per-class model
# ---------------------------------------------------------------------------

@dataclass
class _Lock:
    name: str                       # attribute name, e.g. "_mu"
    kind: str                       # Lock | RLock | Condition | ...
    wraps: Optional[str] = None     # Condition(self._mu) -> "_mu"
    line: int = 0
    is_event: bool = False


@dataclass
class _Field:
    name: str
    guard: Optional[str] = None     # annotated guard token (normalized)
    line: int = 0


@dataclass
class _Access:
    field: str
    kind: str                       # "read" | "write"
    method: str
    line: int
    held: FrozenSet[str]            # local held tokens (pre-entry-set)


@dataclass
class _Acquire:
    lock: str                       # token being acquired
    method: str
    line: int
    held: FrozenSet[str]


@dataclass
class _Blocking:
    desc: str                       # e.g. "time.sleep" / "sock.recv_msg"
    method: str
    line: int
    held: FrozenSet[str]
    releases: FrozenSet[str]        # root mutexes the call itself releases


@dataclass
class _XCall:
    """self.<attr>.<meth>(...) — a call into another modeled class."""
    attr: str
    meth: str
    method: str
    line: int
    held: FrozenSet[str]


@dataclass
class _ClassModel:
    name: str
    path: str
    line: int
    locks: Dict[str, _Lock] = dc_field(default_factory=dict)
    fields: Dict[str, _Field] = dc_field(default_factory=dict)
    thread_roots: Set[str] = dc_field(default_factory=set)
    attr_types: Dict[str, str] = dc_field(default_factory=dict)
    calls: Dict[str, List[Tuple[str, FrozenSet[str]]]] = \
        dc_field(default_factory=dict)   # caller -> [(callee, held@site)]
    methods: Set[str] = dc_field(default_factory=set)
    accesses: List[_Access] = dc_field(default_factory=list)
    acquires: List[_Acquire] = dc_field(default_factory=list)
    blocking: List[_Blocking] = dc_field(default_factory=list)
    xcalls: List[_XCall] = dc_field(default_factory=list)
    entry_held: Dict[str, FrozenSet[str]] = dc_field(default_factory=dict)

    def root(self, token: str) -> str:
        """Normalize a lock token to the mutex actually contended:
        a Condition built over another lock IS that lock."""
        lk = self.locks.get(token)
        if lk is not None and lk.wraps and lk.wraps in self.locks \
                and lk.wraps != token:
            return self.root(lk.wraps)
        return token

    def roots(self, tokens: FrozenSet[str]) -> FrozenSet[str]:
        return frozenset(self.root(t) for t in tokens)


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

def _self_attr(node: ast.AST) -> Optional[str]:
    """'self.X' -> 'X'; anything else -> None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _lock_token(node: ast.AST) -> Optional[str]:
    """A lock-valued expression: self.X -> 'X';
    self.X(...) (per-key lock factory) -> 'X()'."""
    a = _self_attr(node)
    if a is not None:
        return a
    if isinstance(node, ast.Call):
        a = _self_attr(node.func)
        if a is not None:
            return a + "()"
    return None


def _call_tail(func: ast.AST) -> Optional[str]:
    """Last attribute of a call target: time.sleep -> 'sleep'."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _ctor_name(call: ast.Call) -> Optional[str]:
    """threading.RLock() -> 'RLock'; RLock() -> 'RLock'."""
    return _call_tail(call.func)


def _has_timeout(call: ast.Call) -> bool:
    if call.args:
        return True
    return any(kw.arg in ("timeout", "timeout_s") for kw in call.keywords)


class _MethodWalker:
    """Walk one method body tracking the locally held lock set."""

    def __init__(self, cm: _ClassModel, method: str):
        self.cm = cm
        self.method = method

    # -- statements --------------------------------------------------------

    def walk(self, stmts: Sequence[ast.stmt], held: Set[str]):
        held = set(held)
        for st in stmts:
            self._stmt(st, held)

    def _stmt(self, st: ast.stmt, held: Set[str]):
        if isinstance(st, ast.With) or isinstance(st, ast.AsyncWith):
            added = []
            for item in st.items:
                tok = _lock_token(item.context_expr)
                if tok is not None and self._is_lockish(tok):
                    self._record_acquire(tok, item.context_expr.lineno,
                                         held)
                    added.append(tok)
                else:
                    self._expr(item.context_expr, held)
            inner = set(held) | set(added)
            self.walk(st.body, inner)
            return
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda, ast.ClassDef)):
            return   # deferred execution context: skipped (see docstring)
        if isinstance(st, ast.Expr):
            call = st.value
            if isinstance(call, ast.Call):
                tail = _call_tail(call.func)
                recv = call.func.value if isinstance(call.func,
                                                     ast.Attribute) else None
                tok = _lock_token(recv) if recv is not None else None
                if tail == "acquire" and tok and self._is_lockish(tok):
                    self._record_acquire(tok, st.lineno, held)
                    held.add(tok)
                    return
                if tail == "release" and tok and tok in held:
                    held.discard(tok)
                    return
            self._expr(st.value, held)
            return
        if isinstance(st, (ast.If,)):
            self._expr(st.test, held)
            self.walk(st.body, held)
            self.walk(st.orelse, held)
            return
        if isinstance(st, (ast.While,)):
            self._expr(st.test, held)
            self.walk(st.body, held)
            self.walk(st.orelse, held)
            return
        if isinstance(st, ast.For):
            self._target(st.target, held)
            self._expr(st.iter, held)
            self.walk(st.body, held)
            self.walk(st.orelse, held)
            return
        if isinstance(st, ast.Try):
            self.walk(st.body, held)
            for h in st.handlers:
                self.walk(h.body, held)
            self.walk(st.orelse, held)
            self.walk(st.finalbody, held)
            return
        if isinstance(st, ast.Return) and st.value is not None:
            self._expr(st.value, held)
            return
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._assign(st, held)
            return
        if isinstance(st, ast.Delete):
            for t in st.targets:
                self._target(t, held, delete=True)
            return
        if isinstance(st, (ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self._expr(child, held)
            return
        # anything else: visit child expressions generically
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._expr(child, held)
            elif isinstance(child, ast.stmt):
                self._stmt(child, held)

    # -- assignment targets -----------------------------------------------

    def _assign(self, st: ast.stmt, held: Set[str]):
        if isinstance(st, ast.Assign):
            value, targets = st.value, st.targets
        elif isinstance(st, ast.AugAssign):
            value, targets = st.value, [st.target]
            # aug-assign reads then writes the target
            self._expr_attr_read(st.target, held)
        else:   # AnnAssign
            value, targets = st.value, [st.target]
        if value is not None:
            self._expr(value, held)
        for t in targets:
            self._target(t, held)

    def _target(self, t: ast.expr, held: Set[str], delete: bool = False):
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._target(e, held, delete)
            return
        a = _self_attr(t)
        if a is not None:
            self._access(a, "write", t.lineno, held)
            return
        if isinstance(t, ast.Subscript):
            # self.X[k] = v  mutates the container held in self.X
            a = _self_attr(t.value)
            if a is not None:
                self._access(a, "write", t.lineno, held)
            else:
                self._expr(t.value, held)
            self._expr(t.slice, held)
            return
        if isinstance(t, ast.Attribute):
            # x.attr = v where x is not self: read x
            self._expr(t.value, held)
            return
        if isinstance(t, ast.Starred):
            self._target(t.value, held, delete)

    def _expr_attr_read(self, t: ast.expr, held: Set[str]):
        a = _self_attr(t)
        if a is not None:
            self._access(a, "read", t.lineno, held)
        elif isinstance(t, ast.Subscript):
            a = _self_attr(t.value)
            if a is not None:
                self._access(a, "read", t.lineno, held)

    # -- expressions -------------------------------------------------------

    _MUTATORS = frozenset({
        "append", "extend", "insert", "pop", "popitem", "remove",
        "discard", "clear", "update", "setdefault", "add",
        "appendleft", "popleft", "sort", "reverse",
    })

    def _expr(self, e: ast.expr, held: Set[str]):
        if e is None:
            return
        if isinstance(e, (ast.Lambda,)):
            return
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.DictComp,
                          ast.GeneratorExp)):
            # comprehensions run inline on this thread: walk them
            for gen in e.generators:
                self._expr(gen.iter, held)
                for cond in gen.ifs:
                    self._expr(cond, held)
            if isinstance(e, ast.DictComp):
                self._expr(e.key, held)
                self._expr(e.value, held)
            else:
                self._expr(e.elt, held)
            return
        if isinstance(e, ast.Call):
            self._call(e, held)
            return
        a = _self_attr(e)
        if a is not None:
            self._access(a, "read", e.lineno, held)
            return
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self._expr(child, held)

    def _call(self, call: ast.Call, held: Set[str]):
        cm, fs = self.cm, frozenset(held)
        tail = _call_tail(call.func)
        func = call.func

        # thread roots: Thread(target=self.m) / Timer(t, self.m) /
        # executor.submit(self.m, ...)
        self._maybe_thread_root(call, tail)

        handled_recv = False
        if isinstance(func, ast.Attribute):
            recv = func.value
            recv_attr = _self_attr(recv)

            if isinstance(recv, ast.Name) and recv.id == "self":
                # self.<meth>(...)
                cm.calls.setdefault(self.method, []).append((func.attr, fs))
                handled_recv = True
            elif recv_attr is not None:
                # self.<attr>.<meth>(...)
                tok = cm.root(recv_attr) if recv_attr in cm.locks else None
                if tail in ("acquire",) and recv_attr in cm.locks:
                    self._record_acquire(recv_attr, call.lineno, held)
                    handled_recv = True
                elif tail in _TIMEOUT_GATED and not _has_timeout(call):
                    rel = frozenset({tok}) if (
                        tok is not None and
                        cm.locks[recv_attr].kind == "Condition") else \
                        frozenset()
                    cm.blocking.append(_Blocking(
                        f"self.{recv_attr}.{tail}() without timeout",
                        self.method, call.lineno, fs, rel))
                    self._access_maybe(recv_attr, call.lineno, held)
                    handled_recv = True
                elif tail in _BLOCKING_NAMES:
                    cm.blocking.append(_Blocking(
                        f"self.{recv_attr}.{tail}()", self.method,
                        call.lineno, fs, frozenset()))
                    self._access_maybe(recv_attr, call.lineno, held)
                    handled_recv = True
                elif tail in self._MUTATORS:
                    self._access(recv_attr, "write", call.lineno, held)
                    handled_recv = True
                elif recv_attr in cm.attr_types:
                    cm.xcalls.append(_XCall(recv_attr, tail, self.method,
                                            call.lineno, fs))
                    self._access_maybe(recv_attr, call.lineno, held)
                    handled_recv = True
                else:
                    self._access_maybe(recv_attr, call.lineno, held)
                    handled_recv = True
            else:
                # module-or-object call: time.sleep, sock.recv, ...
                base = recv.id if isinstance(recv, ast.Name) else None
                if tail in _BLOCKING_NAMES:
                    who = f"{base}.{tail}" if base else tail
                    cm.blocking.append(_Blocking(
                        who, self.method, call.lineno, fs, frozenset()))
                elif tail in _TIMEOUT_GATED and not _has_timeout(call):
                    who = f"{base}.{tail}" if base else tail
                    cm.blocking.append(_Blocking(
                        f"{who}() without timeout", self.method,
                        call.lineno, fs, frozenset()))
            if not handled_recv:
                self._expr(recv, held)
        elif isinstance(func, ast.Name):
            if tail in _BLOCKING_NAMES:
                cm.blocking.append(_Blocking(
                    tail, self.method, call.lineno, fs, frozenset()))

        for a in call.args:
            self._expr(a, held)
        for kw in call.keywords:
            self._expr(kw.value, held)

    def _maybe_thread_root(self, call: ast.Call, tail: Optional[str]):
        cm = self.cm
        cand: List[ast.expr] = []
        if tail in ("Thread", "Timer"):
            for kw in call.keywords:
                if kw.arg in ("target", "function"):
                    cand.append(kw.value)
            if tail == "Timer" and len(call.args) >= 2:
                cand.append(call.args[1])
        elif tail in ("submit", "map", "run_in_executor"):
            if call.args:
                cand.append(call.args[0])
        for c in cand:
            a = _self_attr(c)
            if a is not None:
                cm.thread_roots.add(a)

    # -- event recording ---------------------------------------------------

    def _is_lockish(self, tok: str) -> bool:
        if tok.endswith("()"):
            # per-key lock factory (`with self._lock(name):`) — only
            # names that say so; arbitrary contextmanager methods
            # (`with self.quiesce():`) are not lock acquisitions
            return "lock" in tok.lower() or "mutex" in tok.lower()
        lk = self.cm.locks.get(tok)
        return lk is not None and not lk.is_event

    def _record_acquire(self, tok: str, line: int, held: Set[str]):
        self.cm.acquires.append(
            _Acquire(tok, self.method, line, frozenset(held)))

    def _access_maybe(self, attr: str, line: int, held: Set[str]):
        """Receiver of a method call on self.X counts as a read of X
        (unknown methods are treated as non-mutating)."""
        if attr in self.cm.locks:
            return
        self._access(attr, "read", line, held)

    def _access(self, attr: str, kind: str, line: int, held: Set[str]):
        if attr in self.cm.locks or attr in self.cm.methods:
            return
        self.cm.accesses.append(
            _Access(attr, kind, self.method, line, frozenset(held)))


def _extract_class(node: ast.ClassDef, path: str,
                   lines: List[str]) -> _ClassModel:
    cm = _ClassModel(name=node.name, path=path, line=node.lineno)
    body_methods = [n for n in node.body
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))]
    cm.methods = {m.name for m in body_methods}

    # pass 1: __init__ — locks, fields (+ guard annotations), attr types
    for m in body_methods:
        if m.name != "__init__":
            continue
        for st in ast.walk(m):
            if not isinstance(st, (ast.Assign, ast.AnnAssign)):
                continue
            targets = st.targets if isinstance(st, ast.Assign) else \
                [st.target]
            value = st.value
            for t in targets:
                a = _self_attr(t)
                if a is None:
                    continue
                if isinstance(value, ast.Call):
                    ctor = _ctor_name(value)
                    if ctor in _MUTEX_CTORS:
                        wraps = None
                        if ctor == "Condition" and value.args:
                            wraps = _self_attr(value.args[0])
                        cm.locks[a] = _Lock(a, ctor, wraps, t.lineno)
                        continue
                    if ctor in _EVENT_CTORS:
                        cm.locks[a] = _Lock(a, ctor, None, t.lineno,
                                            is_event=True)
                        continue
                    if ctor and ctor[0].isupper():
                        cm.attr_types[a] = ctor
                if a not in cm.fields:
                    guard = _guard_annotation(lines, t.lineno)
                    cm.fields[a] = _Field(a, guard, t.lineno)

    # fields assigned a lock later should not double as plain fields
    for lk in cm.locks:
        cm.fields.pop(lk, None)

    # pass 2: walk every method
    for m in body_methods:
        if m.name == "__init__":
            # still collect thread roots + attr types from __init__ body
            w = _MethodWalker(cm, "__init__")
            w.walk(m.body, set())
            continue
        w = _MethodWalker(cm, m.name)
        w.walk(m.body, set())

    # __init__ accesses are pre-publication: drop them from discipline
    cm.accesses = [a for a in cm.accesses if a.method != "__init__"]
    cm.blocking = [b for b in cm.blocking if b.method != "__init__"]
    cm.acquires = [a for a in cm.acquires if a.method != "__init__"]
    cm.xcalls = [x for x in cm.xcalls if x.method != "__init__"]
    return cm


def _guard_annotation(lines: List[str], lineno: int) -> Optional[str]:
    """`# guarded_by: self._mu` trailing the assignment line, or on a
    pure-comment line directly above it (for assignments too long to
    carry a trailing comment). Returns the normalized token ('_mu' or
    '_mu()')."""
    if 1 <= lineno <= len(lines):
        mm = _GUARD_RE.search(lines[lineno - 1])
        if mm:
            return mm.group(1)[len("self."):]
    if 2 <= lineno and lines[lineno - 2].lstrip().startswith("#"):
        mm = _GUARD_RE.search(lines[lineno - 2])
        if mm:
            return mm.group(1)[len("self."):]
    return None


# ---------------------------------------------------------------------------
# interprocedural closures
# ---------------------------------------------------------------------------

def _compute_entry_held(cm: _ClassModel):
    """Fixpoint: a private method called only with lock L held inherits
    {L}; public/dunder/thread-root methods get an implicit external
    caller holding nothing. Intersection over call sites keeps this an
    under-approximation (never invents a held lock)."""
    TOP = None
    entry: Dict[str, Optional[FrozenSet[str]]] = {}
    for mth in cm.methods:
        external = (not mth.startswith("_") or
                    (mth.startswith("__") and mth.endswith("__")) or
                    mth in cm.thread_roots)
        entry[mth] = frozenset() if external else TOP
    changed = True
    while changed:
        changed = False
        for caller, sites in cm.calls.items():
            caller_entry = entry.get(caller)
            if caller_entry is None:
                continue    # unreached so far
            for callee, held in sites:
                if callee not in entry:
                    continue
                eff = frozenset(caller_entry | held)
                cur = entry[callee]
                new = eff if cur is None else (cur & eff)
                if new != cur:
                    entry[callee] = new
                    changed = True
    cm.entry_held = {m: (s if s is not None else frozenset())
                     for m, s in entry.items()}


def _thread_domain(cm: _ClassModel) -> Set[str]:
    """Methods reachable (intra-class) from spawned-thread roots."""
    seen = set(r for r in cm.thread_roots if r in cm.methods)
    work = list(seen)
    while work:
        m = work.pop()
        for callee, _ in cm.calls.get(m, []):
            if callee in cm.methods and callee not in seen:
                seen.add(callee)
                work.append(callee)
    return seen


def _may_block(corpus: Dict[str, _ClassModel]
               ) -> Dict[Tuple[str, str], str]:
    """(class, method) -> witness description, for methods that reach a
    blocking call on some path; propagated through intra-class calls and
    attribute-typed cross-class calls."""
    out: Dict[Tuple[str, str], str] = {}
    for cm in corpus.values():
        for b in cm.blocking:
            out.setdefault((cm.name, b.method), b.desc)
    changed = True
    while changed:
        changed = False
        for cm in corpus.values():
            for caller, sites in cm.calls.items():
                if (cm.name, caller) in out:
                    continue
                for callee, _ in sites:
                    w = out.get((cm.name, callee))
                    if w is not None:
                        out[(cm.name, caller)] = \
                            f"self.{callee}() -> {w}"
                        changed = True
                        break
            for x in cm.xcalls:
                if (cm.name, x.method) in out:
                    continue
                tgt = corpus.get(cm.attr_types.get(x.attr, ""))
                if tgt is None:
                    continue
                w = out.get((tgt.name, x.meth))
                if w is not None:
                    out[(cm.name, x.method)] = \
                        f"self.{x.attr}.{x.meth}() -> {w}"
                    changed = True
    return out


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _eff_held(cm: _ClassModel, method: str,
              held: FrozenSet[str]) -> FrozenSet[str]:
    return cm.roots(held | cm.entry_held.get(method, frozenset()))


class _Suppressions:
    def __init__(self, lines: List[str]):
        self.lines = lines

    def active(self, line: int, code: str) -> bool:
        if not (1 <= line <= len(self.lines)):
            return False
        mm = _IGNORE_RE.search(self.lines[line - 1])
        if not mm:
            return False
        if mm.group(1) is None:
            return True
        return code in {c.strip() for c in mm.group(1).split(",")}


def _check_guards(cm: _ClassModel, sup: _Suppressions
                  ) -> List[ConcurrencyDiagnostic]:
    diags: List[ConcurrencyDiagnostic] = []
    tdom = _thread_domain(cm)
    has_threads = bool(tdom)

    by_field: Dict[str, List[_Access]] = {}
    for a in cm.accesses:
        if a.field in cm.fields or a.field not in cm.attr_types:
            by_field.setdefault(a.field, []).append(a)

    for fname, accs in sorted(by_field.items()):
        fld = cm.fields.get(fname)
        guard = cm.root(fld.guard) if fld and fld.guard else None
        if guard is not None:
            diags.extend(_check_annotated(cm, fname, guard, accs, sup))
        elif has_threads:
            diags.extend(_infer_guard(cm, fname, accs, tdom, sup))
    return diags


def _mk(cm: _ClassModel, code: str, sev: Severity, msg: str, qual: str,
        detail: str, line: int) -> ConcurrencyDiagnostic:
    return ConcurrencyDiagnostic(
        code=code, severity=sev, message=msg, var=qual,
        site=[f"{cm.path}:{line} in {qual}"],
        path=cm.path, qual=qual, detail=detail, line=line)


def _check_annotated(cm: _ClassModel, fname: str, guard: str,
                     accs: List[_Access], sup: _Suppressions
                     ) -> List[ConcurrencyDiagnostic]:
    diags = []
    for a in accs:
        held = _eff_held(cm, a.method, a.held)
        if guard in held:
            continue
        qual = f"{cm.name}.{fname}"
        mqual = f"{cm.name}.{a.method}"
        if held:
            code, sev = "guard-mismatch", Severity.WARNING
            msg = (f"{qual} is annotated guarded_by self.{guard} but "
                   f"{a.kind} in {a.method}() holds "
                   f"{{{', '.join('self.' + h for h in sorted(held))}}} "
                   f"instead")
        elif a.kind == "write":
            code, sev = "unguarded-write", Severity.ERROR
            msg = (f"{qual} is annotated guarded_by self.{guard} but "
                   f"written in {a.method}() with no lock held")
        else:
            code, sev = "unguarded-read", Severity.WARNING
            msg = (f"{qual} is annotated guarded_by self.{guard} but "
                   f"read in {a.method}() with no lock held")
        if sup.active(a.line, code):
            continue
        diags.append(_mk(cm, code, sev, msg, qual,
                         f"{a.kind}@{mqual}", a.line))
    return diags


def _infer_guard(cm: _ClassModel, fname: str, accs: List[_Access],
                 tdom: Set[str], sup: _Suppressions
                 ) -> List[ConcurrencyDiagnostic]:
    """Majority-usage inference for unannotated fields that are shared
    across the thread boundary."""
    in_thread = [a for a in accs if a.method in tdom]
    outside = [a for a in accs if a.method not in tdom]
    wrote = any(a.kind == "write" for a in accs)
    if not (in_thread and outside and wrote):
        return []
    if len(accs) < _INFER_MIN_SITES:
        return []
    counts: Dict[str, int] = {}
    for a in accs:
        for h in _eff_held(cm, a.method, a.held):
            counts[h] = counts.get(h, 0) + 1
    if not counts:
        return []
    guard, n = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
    if n / len(accs) < _INFER_RATIO:
        return []
    qual = f"{cm.name}.{fname}"
    diags = [_mk(
        cm, "guard-inference", Severity.INFO,
        f"{qual} is accessed from both the spawned-thread and caller "
        f"domains; {n}/{len(accs)} accesses hold self.{guard} — "
        f"annotate it `# guarded_by: self.{guard}`",
        qual, f"self.{guard}", cm.fields[fname].line
        if fname in cm.fields else accs[0].line)]
    for a in accs:
        held = _eff_held(cm, a.method, a.held)
        if guard in held:
            continue
        code = "unguarded-write" if a.kind == "write" else "unguarded-read"
        if sup.active(a.line, code):
            continue
        mqual = f"{cm.name}.{a.method}"
        verb = "written" if a.kind == "write" else "read"
        diags.append(_mk(
            cm, code, Severity.WARNING,
            f"{qual} is {verb} in {a.method}() without "
            f"self.{guard}, the inferred guard ({n}/{len(accs)} other "
            f"accesses hold it)",
            qual, f"{a.kind}@{mqual}", a.line))
    return diags


def _check_blocking(cm: _ClassModel, corpus: Dict[str, _ClassModel],
                    may_block: Dict[Tuple[str, str], str],
                    sup: _Suppressions) -> List[ConcurrencyDiagnostic]:
    diags = []
    seen: Set[Tuple[str, int]] = set()

    def emit(desc: str, method: str, line: int,
             held: FrozenSet[str], releases: FrozenSet[str]):
        eff = _eff_held(cm, method, held) - cm.roots(releases)
        if not eff or (method, line) in seen:
            return
        if sup.active(line, "blocking-under-lock"):
            return
        seen.add((method, line))
        qual = f"{cm.name}.{method}"
        locks = ", ".join("self." + h for h in sorted(eff))
        diags.append(_mk(
            cm, "blocking-under-lock", Severity.WARNING,
            f"{qual}() calls {desc} while holding {{{locks}}} — the "
            f"lock is pinned for the full blocking duration (hold-time "
            f"hazard; on a renewal path this eats the failover budget)",
            qual, desc.split("(")[0].strip(), line))

    for b in cm.blocking:
        emit(b.desc, b.method, b.line, b.held, b.releases)
    # calls into methods that transitively block
    for caller, sites in cm.calls.items():
        for callee, held in sites:
            w = may_block.get((cm.name, callee))
            if w is None:
                continue
            # the callee's own frame reports it when it holds the lock
            # itself; here we only report locks held at THIS call site
            line = _call_line(cm, caller, callee)
            emit(f"self.{callee}() [{w}]", caller, line, held,
                 frozenset())
    for x in cm.xcalls:
        tgt = corpus.get(cm.attr_types.get(x.attr, ""))
        if tgt is None:
            continue
        w = may_block.get((tgt.name, x.meth))
        if w is not None:
            emit(f"self.{x.attr}.{x.meth}() [{w}]", x.method, x.line,
                 x.held, frozenset())
    return diags


def _call_line(cm: _ClassModel, caller: str, callee: str) -> int:
    # call sites keep no line today; anchor on the caller's acquires or
    # the class line — the baseline key is line-free anyway
    for a in cm.acquires:
        if a.method == caller:
            return a.line
    return cm.line


def _lock_graph(corpus: Dict[str, _ClassModel]
                ) -> Tuple[Dict[str, Set[str]],
                           Dict[Tuple[str, str], Tuple[str, int, str]]]:
    """Nodes 'Class.lock' (root-normalized); edge A->B when B is
    acquired while A is held. Returns (adjacency, edge witness)."""
    adj: Dict[str, Set[str]] = {}
    wit: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    def add(a: str, b: str, path: str, line: int, desc: str):
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
        wit.setdefault((a, b), (path, line, desc))

    for cm in corpus.values():
        for ac in cm.acquires:
            tgt = cm.root(ac.lock)
            node_b = f"{cm.name}.{tgt}"
            for h in _eff_held(cm, ac.method, ac.held):
                if h == tgt:
                    # re-acquire of the same mutex: only a deadlock on a
                    # non-reentrant plain Lock
                    lk = cm.locks.get(tgt)
                    if lk is not None and lk.kind == "Lock":
                        add(node_b, node_b, cm.path, ac.line,
                            f"{cm.name}.{ac.method}() re-acquires "
                            f"non-reentrant self.{tgt}")
                    continue
                add(f"{cm.name}.{h}", node_b, cm.path, ac.line,
                    f"{cm.name}.{ac.method}() acquires self.{tgt} "
                    f"while holding self.{h}")
        # cross-class: holding my lock, calling into a typed attribute
        for x in cm.xcalls:
            tgt_cm = corpus.get(cm.attr_types.get(x.attr, ""))
            if tgt_cm is None:
                continue
            held_here = _eff_held(cm, x.method, x.held)
            if not held_here:
                continue
            for lock in _locks_taken_by(tgt_cm, x.meth, corpus):
                for h in held_here:
                    add(f"{cm.name}.{h}", lock, cm.path, x.line,
                        f"{cm.name}.{x.method}() holds self.{h} and "
                        f"calls self.{x.attr}.{x.meth}() which "
                        f"acquires {lock}")
    return adj, wit


def _locks_taken_by(cm: _ClassModel, method: str,
                    corpus: Dict[str, _ClassModel],
                    _depth: int = 0) -> Set[str]:
    """Root-normalized 'Class.lock' nodes a method may acquire,
    following intra-class calls (and one more class hop)."""
    out: Set[str] = set()
    seen: Set[str] = set()
    work = [method]
    while work:
        m = work.pop()
        if m in seen:
            continue
        seen.add(m)
        for ac in cm.acquires:
            if ac.method == m and not ac.lock.endswith("()"):
                out.add(f"{cm.name}.{cm.root(ac.lock)}")
        for callee, _ in cm.calls.get(m, []):
            if callee in cm.methods:
                work.append(callee)
        if _depth < 1:
            for x in cm.xcalls:
                if x.method != m:
                    continue
                nxt = corpus.get(cm.attr_types.get(x.attr, ""))
                if nxt is not None:
                    out |= _locks_taken_by(nxt, x.meth, corpus,
                                           _depth + 1)
    return out


def _check_cycles(corpus: Dict[str, _ClassModel]
                  ) -> List[ConcurrencyDiagnostic]:
    adj, wit = _lock_graph(corpus)
    diags: List[ConcurrencyDiagnostic] = []

    # self-cycles first (non-reentrant re-acquire)
    for a in sorted(adj):
        if a in adj[a]:
            path, line, desc = wit[(a, a)]
            diags.append(ConcurrencyDiagnostic(
                code="lock-order-cycle", severity=Severity.ERROR,
                message=f"self-deadlock: {desc}",
                var=a, site=[f"{path}:{line}"],
                path=path, qual=a, detail=a, line=line))

    # Tarjan SCC (iterative)
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    counter = [0]
    sccs: List[List[str]] = []

    def strongconnect(root: str):
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                elif w in on:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

    for node in sorted(adj):
        if node not in index:
            strongconnect(node)

    for comp in sccs:
        edges = [(a, b) for a in comp for b in adj.get(a, ())
                 if b in comp and a != b]
        witness = "; ".join(
            wit[(a, b)][2] for a, b in sorted(edges)[:4]
            if (a, b) in wit)
        path, line, _ = wit[sorted(edges)[0]] if edges else ("", 0, "")
        diags.append(ConcurrencyDiagnostic(
            code="lock-order-cycle", severity=Severity.ERROR,
            message=(f"lock-order cycle between "
                     f"{{{', '.join(comp)}}}: {witness} — a consistent "
                     f"acquisition order (or lock-free handoff) is "
                     f"required"),
            var=",".join(comp), site=[f"{path}:{line}"],
            path=path, qual=comp[0], detail=",".join(comp), line=line))
    return diags


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _extract_module(src: str, path: str) -> List[_ClassModel]:
    if _SKIP_FILE_RE.search("\n".join(src.splitlines()[:10])):
        return []
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return []
    lines = src.splitlines()
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            cm = _extract_class(node, path, lines)
            _compute_entry_held(cm)
            out.append(cm)
    return out


def _analyze_corpus(modules: List[Tuple[str, str]]
                    ) -> List[ConcurrencyDiagnostic]:
    """modules: [(source, repo-relative path)]."""
    corpus: Dict[str, _ClassModel] = {}
    per_file: Dict[str, List[_ClassModel]] = {}
    sups: Dict[str, _Suppressions] = {}
    for src, path in modules:
        cms = _extract_module(src, path)
        per_file.setdefault(path, []).extend(cms)
        sups[path] = _Suppressions(src.splitlines())
        for cm in cms:
            corpus.setdefault(cm.name, cm)
    mb = _may_block(corpus)
    diags: List[ConcurrencyDiagnostic] = []
    for path, cms in sorted(per_file.items()):
        sup = sups[path]
        for cm in cms:
            diags.extend(_check_guards(cm, sup))
            diags.extend(_check_blocking(cm, corpus, mb, sup))
    diags.extend(_check_cycles(corpus))
    diags.sort(key=lambda d: (-int(d.severity), d.path, d.line, d.code))
    return diags


def analyze_source(src: str, filename: str = "<string>"
                   ) -> List[ConcurrencyDiagnostic]:
    """Analyze one module's source text (fixture entry point)."""
    return _analyze_corpus([(src, filename)])


def analyze_paths(paths: Sequence[str], root: Optional[str] = None
                  ) -> List[ConcurrencyDiagnostic]:
    """Analyze a set of .py files together (one corpus: cross-class
    edges resolve across files). `root` anchors repo-relative paths."""
    modules = []
    for p in paths:
        try:
            with open(p, encoding="utf-8") as f:
                src = f.read()
        except OSError:
            continue
        rel = os.path.relpath(p, root) if root else p
        modules.append((src, rel))
    return _analyze_corpus(modules)


def analyze_package(pkg_dir: str, root: Optional[str] = None
                    ) -> List[ConcurrencyDiagnostic]:
    """Analyze every .py under a directory tree."""
    paths = []
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d not in ("__pycache__",)]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                paths.append(os.path.join(dirpath, fn))
    return analyze_paths(paths, root=root or os.path.dirname(
        os.path.abspath(pkg_dir)))
