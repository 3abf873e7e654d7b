"""Lock-order analysis for the concurrent compile machinery.

The farm/service stack holds several locks (artifact store, disk tier,
stack caches, master tables, async dispatch) whose discipline — never
acquire them in inconsistent orders, never hold one across the
``compile_many`` stacked-sweep barrier — is enforced only by
convention.  This module makes the convention checkable:

**Runtime instrumentation** (opt-in, ``PFDNN_LOCKCHECK=1``): every
lock in the service/core paths is constructed through
:func:`make_lock`.  Normally that returns a plain
``threading.Lock``/``RLock`` with zero overhead; under instrumentation
it returns a named wrapper that records, per thread, the stack of held
locks and adds an edge ``held → acquired`` to a process-global
acquisition graph on every nested acquire.  A cycle in that graph is a
lock-order inversion (two call paths that could deadlock under the
right interleaving); :func:`barrier` marks dispatch points that must
never be reached with a lock held (the ``compile_many`` stacked-sweep
round loop blocks on worker completion — holding a store lock there
starves every other compilation).

Worker *processes* (the compile farm) each build their own graph; when
``PFDNN_LOCKCHECK_DUMP=<path>`` is set, every process appends its graph
as one JSON line at exit, and :func:`merge_dumps` reads back the union
for :func:`check`.

**Static companion**: :func:`static_lock_nesting` AST-scans the
service/core modules for textually nested ``with <lock>`` blocks and
cross-checks them against the recorded runtime graph — a static
nesting that never showed up at runtime means the test suite did not
exercise that path (reported as uncovered, not an error).

Stdlib-only on purpose: ``repro_torch.core`` and ``repro_torch.service``
import this module at module scope, so it must never import them back.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import pathlib
import threading

__all__ = [
    "LockOrderError",
    "make_lock",
    "barrier",
    "enabled",
    "enable",
    "disable",
    "reset",
    "graph",
    "find_cycles",
    "check",
    "assert_clean",
    "dump",
    "merge_dumps",
    "static_lock_nesting",
    "cross_check",
]


class LockOrderError(AssertionError):
    """A lock-order inversion (cycle) or barrier hazard was recorded."""


# ------------------------------------------------------ recorder state

class _Recorder:
    """Process-global acquisition recorder (one per enable())."""

    def __init__(self) -> None:
        self.mu = threading.Lock()
        # (held_name, acquired_name) -> acquisition count
        self.edges: dict[tuple[str, str], int] = {}
        # barrier tag -> sorted tuples of lock names held when crossed
        self.hazards: dict[str, list[list[str]]] = {}
        self.locks_seen: set[str] = set()
        self.local = threading.local()

    def held_stack(self) -> list[str]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def on_acquire(self, name: str) -> None:
        held = self.held_stack()
        with self.mu:
            self.locks_seen.add(name)
            for h in held:
                if h != name:          # re-entrant self-acquire is fine
                    key = (h, name)
                    self.edges[key] = self.edges.get(key, 0) + 1
        held.append(name)

    def on_release(self, name: str) -> None:
        held = self.held_stack()
        # release the innermost matching hold (RLock release order)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def on_barrier(self, tag: str) -> None:
        held = self.held_stack()
        if held:
            with self.mu:
                self.hazards.setdefault(tag, []).append(list(held))


_RECORDER: _Recorder | None = None
_ENV_FLAG = "PFDNN_LOCKCHECK"
_ENV_DUMP = "PFDNN_LOCKCHECK_DUMP"


def enabled() -> bool:
    """True when acquisitions are being recorded in this process."""
    return _RECORDER is not None


def enable() -> None:
    """Start recording (idempotent).  Locks constructed *after* this
    call are instrumented; existing plain locks stay plain."""
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = _Recorder()


def disable() -> None:
    global _RECORDER
    _RECORDER = None


def reset() -> None:
    """Drop every recorded edge/hazard (keeps recording enabled)."""
    global _RECORDER
    if _RECORDER is not None:
        _RECORDER = _Recorder()


if os.environ.get(_ENV_FLAG) == "1":
    enable()
    if os.environ.get(_ENV_DUMP):
        import atexit

        atexit.register(lambda: dump(os.environ[_ENV_DUMP]))


# ------------------------------------------------------ the lock wrapper

class _InstrumentedLock:
    """Named lock recording nested acquisitions.  Wraps a real
    ``Lock``/``RLock`` — blocking semantics are unchanged; only
    successful acquires/releases touch the (thread-local) held stack."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, reentrant: bool) -> None:
        self.name = name
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok and _RECORDER is not None:
            _RECORDER.on_acquire(self.name)
        return ok

    def release(self) -> None:
        if _RECORDER is not None:
            _RECORDER.on_release(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<InstrumentedLock {self.name!r}>"


def make_lock(name: str, *, reentrant: bool = False):
    """Construct a lock for the service/core machinery.

    Returns a plain ``threading.Lock``/``RLock`` (zero overhead) unless
    lock-order recording is enabled in this process, in which case the
    lock is a named :class:`_InstrumentedLock`.  ``name`` should be the
    ``<module>.<attr>`` the static companion will see (e.g.
    ``"store._lock"``).
    """
    if _RECORDER is None:
        return threading.RLock() if reentrant else threading.Lock()
    return _InstrumentedLock(name, reentrant)


def barrier(tag: str) -> None:
    """Mark a dispatch point that must never be crossed holding an
    instrumented lock (e.g. the ``compile_many`` stacked-sweep round
    loop).  No-op unless recording is enabled."""
    if _RECORDER is not None:
        _RECORDER.on_barrier(tag)


# ------------------------------------------------------ graph queries

def graph() -> dict:
    """Snapshot of the recorded acquisition graph."""
    if _RECORDER is None:
        return {"edges": {}, "hazards": {}, "locks": []}
    with _RECORDER.mu:
        return {
            "edges": {f"{a} -> {b}": n
                      for (a, b), n in sorted(_RECORDER.edges.items())},
            "hazards": {t: [list(h) for h in hs]
                        for t, hs in sorted(_RECORDER.hazards.items())},
            "locks": sorted(_RECORDER.locks_seen),
        }


def find_cycles(edges) -> list[list[str]]:
    """Elementary cycles (as node lists) in an ``{(a, b): n}`` or
    ``[(a, b), ...]`` edge collection, via iterative DFS."""
    adj: dict[str, list[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    cycles: list[list[str]] = []
    seen_cycles: set[tuple[str, ...]] = set()
    color: dict[str, int] = {}          # 0 unvisited, 1 on stack, 2 done

    def dfs(start: str) -> None:
        stack: list[tuple[str, iter]] = [(start, iter(adj[start]))]
        path = [start]
        color[start] = 1
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color.get(nxt, 0) == 1:
                    i = path.index(nxt)
                    cyc = path[i:]
                    # canonicalize rotation so each cycle reports once
                    j = cyc.index(min(cyc))
                    canon = tuple(cyc[j:] + cyc[:j])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        cycles.append(list(canon))
                elif color.get(nxt, 0) == 0:
                    color[nxt] = 1
                    path.append(nxt)
                    stack.append((nxt, iter(adj[nxt])))
                    advanced = True
                    break
            if not advanced:
                color[node] = 2
                path.pop()
                stack.pop()

    for node in sorted(adj):
        if color.get(node, 0) == 0:
            dfs(node)
    return cycles


def check(extra_edges=()) -> dict:
    """Cycle/hazard report over the recorded graph (plus optional
    merged edges from other processes)."""
    g = graph()
    edges = [tuple(k.split(" -> ")) for k in g["edges"]]
    edges += [tuple(e) for e in extra_edges]
    cycles = find_cycles(edges)
    hazards = [
        {"barrier": tag, "held": held}
        for tag, holds in g["hazards"].items() for held in holds
    ]
    return {"edges": sorted(set(edges)), "cycles": cycles,
            "hazards": hazards,
            "ok": not cycles and not hazards}


def assert_clean(extra_edges=()) -> dict:
    """Raise :class:`LockOrderError` on any cycle or barrier hazard."""
    report = check(extra_edges)
    if not report["ok"]:
        raise LockOrderError(
            "lock discipline violated: "
            f"cycles={report['cycles']} hazards={report['hazards']}")
    return report


# ------------------------------------------------------ dump / merge

def dump(path) -> None:
    """Append this process's graph as one JSON line (atomic enough:
    a single ``write`` of one line in append mode)."""
    if _RECORDER is None:
        return
    line = json.dumps({"pid": os.getpid(), **graph()}) + "\n"
    with open(path, "a") as fh:
        fh.write(line)


def merge_dumps(path) -> dict:
    """Union of every dumped per-process graph at ``path``."""
    edges: dict[tuple[str, str], int] = {}
    hazards: list[dict] = []
    locks: set[str] = set()
    text = pathlib.Path(path).read_text()
    for line in text.splitlines():
        if not line.strip():
            continue
        rec = json.loads(line)
        for key, n in rec.get("edges", {}).items():
            a, b = key.split(" -> ")
            edges[(a, b)] = edges.get((a, b), 0) + n
        for tag, holds in rec.get("hazards", {}).items():
            for held in holds:
                hazards.append({"barrier": tag, "held": held,
                                "pid": rec.get("pid")})
        locks.update(rec.get("locks", []))
    return {"edges": edges, "hazards": hazards, "locks": sorted(locks)}


# ------------------------------------------------------ static companion

#: attribute names that hold locks in the scanned modules
_LOCK_ATTRS = frozenset({"_lock", "_async_lock", "_master_lock",
                         "agg_lock", "lock"})

#: a static ``<module>.<attr>`` name may correspond to several runtime
#: lock names (one module can define locks on several classes)
STATIC_ALIASES: dict[str, tuple[str, ...]] = {
    "backend._lock": ("backend.bucket._lock", "backend.stacks._lock"),
}


@dataclasses.dataclass(frozen=True)
class StaticNesting:
    """One textually nested ``with <lock>`` pair."""

    outer: str
    inner: str
    path: str
    line: int


def _lock_name(node: ast.expr, module: str) -> str | None:
    """``self._lock`` / ``lock`` / ``obj.agg_lock`` → ``module.attr``."""
    if isinstance(node, ast.Attribute) and node.attr in _LOCK_ATTRS:
        return f"{module}.{node.attr}"
    if isinstance(node, ast.Name) and node.id in _LOCK_ATTRS:
        return f"{module}.{node.id}"
    return None


class _WithNestingVisitor(ast.NodeVisitor):
    def __init__(self, module: str, path: str) -> None:
        self.module = module
        self.path = path
        self.stack: list[str] = []
        self.found: list[StaticNesting] = []

    def visit_With(self, node: ast.With) -> None:
        names = [n for item in node.items
                 if (n := _lock_name(item.context_expr,
                                     self.module)) is not None]
        for name in names:
            for outer in self.stack:
                if outer != name:
                    self.found.append(StaticNesting(
                        outer, name, self.path, node.lineno))
        self.stack.extend(names)
        self.generic_visit(node)
        for _ in names:
            self.stack.pop()

    # a nested function/lambda body does not run under the enclosing
    # ``with`` at definition time — reset the stack across boundaries
    def visit_FunctionDef(self, node):  # noqa: N802
        saved, self.stack = self.stack, []
        self.generic_visit(node)
        self.stack = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):  # noqa: N802
        saved, self.stack = self.stack, []
        self.generic_visit(node)
        self.stack = saved


def static_lock_nesting(root) -> list[StaticNesting]:
    """Scan ``root`` (a directory of Python modules, typically
    ``src/repro_torch``) for textually nested ``with <lock>`` acquisitions."""
    rootp = pathlib.Path(root)
    out: list[StaticNesting] = []
    for path in sorted(rootp.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        visitor = _WithNestingVisitor(path.stem, str(path))
        visitor.visit(tree)
        out.extend(visitor.found)
    return out


def cross_check(static: list[StaticNesting],
                runtime_edges) -> dict:
    """Compare static ``with``-nesting pairs against the recorded
    runtime acquisition graph.

    Every static pair should be *covered* by a runtime edge (under
    :data:`STATIC_ALIASES` name expansion) — an uncovered pair means
    the instrumented run never exercised that nesting.  Coverage gaps
    are reported, not fatal; cycles among the static pairs themselves
    are fatal (they are order inversions visible in the source).
    """
    runtime = {tuple(e) for e in runtime_edges}

    def aliases(name: str) -> tuple[str, ...]:
        return STATIC_ALIASES.get(name, (name,))

    uncovered = []
    static_edges = set()
    for nest in static:
        static_edges.add((nest.outer, nest.inner))
        covered = any((a, b) in runtime
                      for a in aliases(nest.outer)
                      for b in aliases(nest.inner))
        if not covered:
            uncovered.append(dataclasses.asdict(nest))
    cycles = find_cycles(sorted(static_edges))
    return {"static_pairs": sorted(static_edges),
            "uncovered": uncovered,
            "static_cycles": cycles,
            "ok": not cycles}
