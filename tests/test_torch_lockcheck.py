"""The port's lock-order checker (``repro_torch.analysis.lockcheck``):
the reference's lock-order cases (``tests/test_analysis.py``) run on
the port's copy, the port's source names the same locks through
``make_lock`` (apart from those of the thread-pool sweep, which the
port leaves out) and nests them the same way as the reference's,
module for module, and a threaded ``compile_many`` recorded under the checker
is clean (no cycle, no lock held across the ``compile_many``
barrier) and agrees with the static scan."""

import ast
import pathlib
import textwrap
import threading

import pytest

from conftest import max_rate
from repro.analysis import lockcheck as ref_lockcheck
from repro_torch.analysis import lockcheck
from repro_torch.core import OrchestratorConfig
from repro_torch.models.edge_cnn import edge_network
from repro_torch.service import CompileRequest, CompileService

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
PORT, REF = SRC / "repro_torch", SRC / "repro"


@pytest.fixture
def recording():
    was = lockcheck.enabled()
    lockcheck.enable()
    lockcheck.reset()
    yield
    lockcheck.reset()
    if not was:
        lockcheck.disable()


# ------------------------------------------ the reference's cases

def test_make_lock_plain_when_disabled():
    if lockcheck.enabled():
        pytest.skip("suite running under PFDNN_LOCKCHECK=1")
    lock = lockcheck.make_lock("x._lock")
    assert isinstance(lock, type(threading.Lock()))
    assert isinstance(lockcheck.make_lock("x._lock", reentrant=True),
                      type(threading.RLock()))


def test_nested_acquire_records_edge(recording):
    a = lockcheck.make_lock("a._lock")
    b = lockcheck.make_lock("b._lock")
    with a:
        with b:
            pass
    assert lockcheck.graph()["edges"] == {"a._lock -> b._lock": 1}
    assert lockcheck.assert_clean()["ok"]


def test_opposite_orders_form_cycle(recording):
    a = lockcheck.make_lock("a._lock")
    b = lockcheck.make_lock("b._lock")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert lockcheck.check()["cycles"] == [["a._lock", "b._lock"]]
    with pytest.raises(lockcheck.LockOrderError):
        lockcheck.assert_clean()


def test_reentrant_self_acquire_is_not_an_edge(recording):
    r = lockcheck.make_lock("r._lock", reentrant=True)
    with r:
        with r:
            pass
    assert lockcheck.graph()["edges"] == {}


def test_barrier_hazard(recording):
    a = lockcheck.make_lock("a._lock")
    lockcheck.barrier("clear")           # nothing held: fine
    with a:
        lockcheck.barrier("compile_many")
    report = lockcheck.check()
    assert report["hazards"] == [
        {"barrier": "compile_many", "held": ["a._lock"]}]
    assert not report["ok"]


def test_edges_recorded_across_threads(recording):
    a = lockcheck.make_lock("a._lock")
    b = lockcheck.make_lock("b._lock")

    def worker():
        with a:
            with b:
                pass

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert lockcheck.graph()["edges"] == {"a._lock -> b._lock": 4}


def test_dump_and_merge(recording, tmp_path):
    a = lockcheck.make_lock("a._lock")
    b = lockcheck.make_lock("b._lock")
    with a:
        with b:
            pass
    path = tmp_path / "graph.jsonl"
    lockcheck.dump(path)
    lockcheck.dump(path)                 # second "process"
    merged = lockcheck.merge_dumps(path)
    assert merged["edges"] == {("a._lock", "b._lock"): 2}
    assert merged["locks"] == ["a._lock", "b._lock"]
    assert merged["hazards"] == []
    # the reference reads the port's dump alike
    assert ref_lockcheck.merge_dumps(path) == merged


def test_find_cycles_three_node():
    edges = [("a", "b"), ("b", "c"), ("c", "a"), ("c", "d")]
    assert lockcheck.find_cycles(edges) == [["a", "b", "c"]]
    assert lockcheck.find_cycles([("a", "b"), ("b", "c")]) == []


def test_static_nesting_scan(tmp_path):
    (tmp_path / "mod.py").write_text(textwrap.dedent("""\
        class C:
            def f(self):
                with self._lock:
                    with self.agg_lock:
                        pass

            def g(self):
                with self._lock:
                    def inner():
                        with self.agg_lock:   # new frame: not nested
                            pass
                    return inner
    """))
    nests = lockcheck.static_lock_nesting(tmp_path)
    assert [(n.outer, n.inner) for n in nests] == \
        [("mod._lock", "mod.agg_lock")]
    assert [(n.outer, n.inner, n.line) for n in nests] == \
        [(n.outer, n.inner, n.line)
         for n in ref_lockcheck.static_lock_nesting(tmp_path)]


def test_cross_check_coverage_and_cycles(tmp_path):
    (tmp_path / "m.py").write_text(textwrap.dedent("""\
        def f(self):
            with self._lock:
                with self.agg_lock:
                    pass
    """))
    nests = lockcheck.static_lock_nesting(tmp_path)
    covered = lockcheck.cross_check(nests, [("m._lock", "m.agg_lock")])
    assert covered["ok"] and covered["uncovered"] == []
    uncovered = lockcheck.cross_check(nests, [])
    assert uncovered["ok"]               # coverage gaps are non-fatal
    assert len(uncovered["uncovered"]) == 1
    (tmp_path / "n.py").write_text(textwrap.dedent("""\
        def g(self):
            with self.agg_lock:
                with self._lock:
                    pass
    """))
    renamed = [lockcheck.StaticNesting(
        n.outer.split(".", 1)[1], n.inner.split(".", 1)[1],
        n.path, n.line) for n in lockcheck.static_lock_nesting(tmp_path)]
    report = lockcheck.cross_check(renamed, [])
    assert not report["ok"] and report["static_cycles"]


def test_instrumented_lock_nonblocking_and_locked(recording):
    a = lockcheck.make_lock("a._lock")
    assert a.acquire(blocking=False)
    assert a.locked()
    assert not a.acquire(blocking=False)  # failed acquire: no record
    a.release()
    assert not a.locked()
    assert lockcheck.graph()["edges"] == {}


# ------------------------------------- the port's locks vs the reference's

def _lock_names(root: pathlib.Path) -> dict[str, set[str]]:
    """``make_lock("<name>")`` names constructed in each module."""
    out: dict[str, set[str]] = {}
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) \
                    and getattr(node.func, "id", None) == "make_lock" \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant):
                out.setdefault(path.relative_to(root).as_posix(),
                               set()).add(node.args[0].value)
    return out


def _ported(rel: str) -> bool:
    return (PORT / rel).exists()


# locks of the reference's thread-pool sweep, which the port leaves out
NOT_PORTED = {"core/rails.py": {"rails._sweep_lock"},
              "core/policies.py": {"policies._agg_lock"}}


def test_port_names_the_reference_locks():
    ref = {rel: names - NOT_PORTED.get(rel, set())
           for rel, names in _lock_names(REF).items() if _ported(rel)}
    port = _lock_names(PORT)
    assert port == {rel: names for rel, names in ref.items() if names}
    assert {"core/backend.py", "core/context.py", "service/store.py",
            "service/disk.py", "service/compile_service.py"} <= set(port)


def test_static_nesting_matches_the_reference():
    def edges(root, nests):
        return sorted((pathlib.Path(n.path).relative_to(root).as_posix(),
                       n.outer, n.inner) for n in nests
                      if _ported(pathlib.Path(n.path)
                                 .relative_to(root).as_posix()))

    assert edges(PORT, lockcheck.static_lock_nesting(PORT)) == \
        edges(REF, ref_lockcheck.static_lock_nesting(REF))


def test_threaded_compile_many_is_clean(recording):
    """Two threads run overlapping compile_many batches on one service
    (locks built after recording starts are instrumented): no cycle,
    no lock held across the compile_many barrier, and every static
    nesting of the port is either covered or absent."""
    cfg = OrchestratorConfig(policy="pfdnn", n_max_rails=2, device="cpu")
    nets = ("squeezenet1.1", "mobilenetv3-small")
    reqs = [CompileRequest(edge_network(n), 0.9 * max_rate(n), cfg, n)
            for n in nets]
    svc = CompileService(use_schedule_cache=False)
    errors: list[BaseException] = []

    def run(order):
        try:
            svc.compile_many([reqs[i] for i in order])
        except BaseException as exc:
            errors.append(exc)

    ts = [threading.Thread(target=run, args=(o,))
          for o in ([0, 1], [1, 0])]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    report = lockcheck.assert_clean()
    seen = set(lockcheck.graph()["locks"])
    assert {"backend.bucket._lock", "backend.stacks._lock",
            "context._master_lock", "store._lock"} <= seen
    static = lockcheck.static_lock_nesting(PORT)
    assert lockcheck.cross_check(static, report["edges"])["ok"]
