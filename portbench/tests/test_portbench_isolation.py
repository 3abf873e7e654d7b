"""What the benchmark may load: no module of ``portbench/`` imports JAX,
``jaxlib`` or the JAX package ``repro`` (each import's top-level name
compared whole, so ``repro_torch`` is not ``repro``); nothing under
``portbench/reference/`` imports the program (``repro_torch``); no file
names a path into ``benchmarks/``."""

import ast
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.testing import few_threads  # noqa: E402,F401

PORTBENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(PORTBENCH.rglob("*.py"))


def imported(path: Path) -> set:
    """The top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_comparison_is_by_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.models\nfrom repro_torch import x\n"
                   "import jax.numpy\n")
    assert imported(src) == {"repro_torch", "jax"}
    from portbench import testing

    run = testing.runner()
    assert run.forbidden_modules(["repro_torch.models", "reprox"]) == []
    assert run.forbidden_modules(["jax.numpy", "repro.core", "flax"]) == \
        ["flax", "jax", "repro"]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((PORTBENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_the_reference_takes_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)
    assert "repro_torch" not in path.read_text()


def test_nothing_reads_the_old_benchmarks_folder():
    pattern = re.compile(r"""["'/]benchmarks/|ROOT\s*/\s*["']benchmarks""")
    for path in FILES + [ROOT / "BENCHMARK.json"]:
        if path.name == Path(__file__).name:
            continue
        assert not pattern.search(path.read_text()), path


def test_a_run_loads_no_jax(tmp_path, capsys):
    """A whole run of a cell, in this process, leaves no forbidden
    module among those it loaded."""
    from portbench import spec, testing

    before = set(sys.modules)
    root = testing.tiny_root(tmp_path)
    cell = spec.benchmark()["workloads"][-1]["name"]
    rc, _, _ = testing.run_cell(root, cell, capsys)
    assert rc == 0
    loaded = {m.split(".")[0] for m in set(sys.modules) - before}
    assert not loaded & FORBIDDEN
