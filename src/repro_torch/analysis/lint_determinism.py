"""AST determinism linter for the compiler source tree.

The repo's core contract is bit-reproducibility: the same specs +
config must compile to byte-identical artifacts on every backend, in
every process of the farm, forever.  Four classes of source construct
quietly break that contract; this pass flags them:

  - ``unseeded-rng``   — module-level ``np.random.*`` / ``random.*``
    calls and ``default_rng()`` with no seed: results change run to
    run.
  - ``wall-clock``     — ``time.time`` / ``perf_counter`` /
    ``monotonic`` / ``datetime.now`` reads: fine for *reporting*
    (benchmark walls), poison when they feed anything content-addressed
    or compared across processes.
  - ``set-iteration``  — a ``for`` loop / list- or generator-
    comprehension over a set expression: iteration order is
    hash-seed-dependent, so any *ordered* output it feeds (a list, a
    schedule, a cache key) becomes nondeterministic.  Iterating into
    an unordered sink (set/dict comprehension) is fine; so is
    ``sorted(set(...))``.
  - ``float-accum``    — ``sum()`` over a set expression: float
    addition does not commute, so an unordered iterable makes the
    total hash-seed-dependent.

Intentional uses carry an inline ``# pfdnn: allow(<rule>)`` suppression
on the flagged line (self-documenting at the use site), or an entry in
a committed baseline file (``--write-baseline``) keyed by
``(relative path, rule, stripped source line)`` so line-number churn
does not invalidate it.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re

RULES = ("unseeded-rng", "wall-clock", "set-iteration", "float-accum")

#: (path substring, rule) pairs exempt by design: the calibration
#: harness's measure loop and the launch wrappers report wall time by
#: construction (their walls never feed content-addressed state)
DEFAULT_ALLOWLIST: tuple[tuple[str, str], ...] = ()

_ALLOW_RE = re.compile(
    r"#\s*pfdnn:\s*allow\(\s*([a-z0-9_,\s-]+?)\s*\)")

#: wall-clock reads (resolved through import aliases)
_WALL_CLOCK_FNS = frozenset({
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.date.today",
})

#: numpy.random constructors that are deterministic once seeded
_SEEDED_RNG_CTORS = frozenset({
    "numpy.random.default_rng", "numpy.random.Generator",
    "numpy.random.SeedSequence", "numpy.random.PCG64",
    "numpy.random.Philox", "numpy.random.RandomState",
})


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str
    text: str           # the stripped source line (baseline key part)

    def fingerprint(self) -> tuple[str, str, str]:
        return (self.path, self.rule, self.text)

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: [{self.rule}] "
                f"{self.message}")


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, lines: list[str]) -> None:
        self.path = path
        self.lines = lines
        self.aliases: dict[str, str] = {}   # local name -> dotted module
        self.findings: list[Finding] = []

    # ---- import alias tracking
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.aliases[alias.asname or alias.name.split(".")[0]] = \
                alias.name if alias.asname else alias.name.split(".")[0]
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and node.level == 0:
            for alias in node.names:
                self.aliases[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
        self.generic_visit(node)

    # ---- helpers
    def _dotted(self, node: ast.expr) -> str | None:
        """Resolve ``np.random.rand`` → ``numpy.random.rand`` using the
        recorded import aliases; None for non-name expressions."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.aliases.get(node.id, node.id)
        if node.id == "np":
            root = "numpy"
        return ".".join([root] + list(reversed(parts)))

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        line = node.lineno
        text = self.lines[line - 1].strip() if line <= len(self.lines) \
            else ""
        self.findings.append(Finding(
            path=self.path, line=line, col=node.col_offset,
            rule=rule, message=message, text=text))

    @staticmethod
    def _is_set_expr(node: ast.expr) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("set", "frozenset"):
            return True
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            # set algebra: flag only when a side is itself set-ish
            return (_Visitor._is_set_expr(node.left)
                    or _Visitor._is_set_expr(node.right))
        return False

    # ---- rules
    def visit_Call(self, node: ast.Call) -> None:
        dotted = self._dotted(node.func)
        if dotted:
            if dotted.startswith("numpy.random."):
                if dotted in _SEEDED_RNG_CTORS:
                    if not node.args and not node.keywords:
                        self._emit(node, "unseeded-rng",
                                   f"{dotted}() without a seed")
                else:
                    self._emit(node, "unseeded-rng",
                               f"module-level RNG call {dotted}()")
            elif dotted.startswith("random."):
                if dotted in ("random.Random", "random.SystemRandom"):
                    if not node.args and not node.keywords:
                        self._emit(node, "unseeded-rng",
                                   f"{dotted}() without a seed")
                else:
                    self._emit(node, "unseeded-rng",
                               f"stdlib RNG call {dotted}()")
            elif dotted in _WALL_CLOCK_FNS:
                self._emit(node, "wall-clock",
                           f"wall-clock read {dotted}()")
        if isinstance(node.func, ast.Name) and node.func.id == "sum" \
                and node.args and self._is_set_expr(node.args[0]):
            self._emit(node, "float-accum",
                       "sum() over an unordered set — float addition "
                       "does not commute")
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if self._is_set_expr(node.iter):
            self._emit(node, "set-iteration",
                       "for-loop over a set expression — iteration "
                       "order is hash-seed-dependent")
        self.generic_visit(node)

    def _check_comp(self, node, kind: str) -> None:
        for gen in node.generators:
            if self._is_set_expr(gen.iter):
                self._emit(node, "set-iteration",
                           f"{kind} over a set expression feeds an "
                           "ordered output")
        self.generic_visit(node)

    def visit_ListComp(self, node: ast.ListComp) -> None:
        self._check_comp(node, "list comprehension")

    def visit_GeneratorExp(self, node: ast.GeneratorExp) -> None:
        self._check_comp(node, "generator expression")


def _allowed_rules_on_line(line: str) -> set[str]:
    m = _ALLOW_RE.search(line)
    if not m:
        return set()
    return {r.strip() for r in m.group(1).split(",") if r.strip()}


def lint_source(source: str, path: str) -> list[Finding]:
    """Lint one module's source.  Findings suppressed by an inline
    ``# pfdnn: allow(<rule>)`` on their line are dropped here."""
    lines = source.splitlines()
    tree = ast.parse(source, filename=path)
    visitor = _Visitor(path, lines)
    visitor.visit(tree)
    out = []
    for f in visitor.findings:
        raw = lines[f.line - 1] if f.line <= len(lines) else ""
        if f.rule in _allowed_rules_on_line(raw):
            continue
        out.append(f)
    return out


def lint_tree(root, *, allowlist=DEFAULT_ALLOWLIST) -> list[Finding]:
    """Lint every ``*.py`` under ``root`` (paths reported relative to
    it).  ``allowlist`` drops (path substring, rule) matches."""
    rootp = pathlib.Path(root)
    findings: list[Finding] = []
    for path in sorted(rootp.rglob("*.py")):
        rel = path.relative_to(rootp).as_posix()
        for f in lint_source(path.read_text(), rel):
            if any(sub in rel and rule == f.rule
                   for sub, rule in allowlist):
                continue
            findings.append(f)
    return findings


# ------------------------------------------------------------- baseline

def load_baseline(path) -> set[tuple[str, str, str]]:
    p = pathlib.Path(path)
    if not p.exists():
        return set()
    entries = json.loads(p.read_text())
    return {(e["path"], e["rule"], e["text"]) for e in entries}


def save_baseline(path, findings: list[Finding]) -> None:
    entries = [{"path": f.path, "rule": f.rule, "text": f.text}
               for f in findings]
    entries.sort(key=lambda e: (e["path"], e["rule"], e["text"]))
    pathlib.Path(path).write_text(json.dumps(entries, indent=2) + "\n")


def apply_baseline(findings: list[Finding], baseline) \
        -> tuple[list[Finding], list[Finding]]:
    """Split ``findings`` into (new, baseline-suppressed)."""
    new, suppressed = [], []
    for f in findings:
        (suppressed if f.fingerprint() in baseline else new).append(f)
    return new, suppressed
