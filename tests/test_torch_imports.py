"""Import hygiene of the port: no module under ``src/repro_torch/`` and
not ``chip_smoke.py`` imports ``jax``, ``jaxlib``, the JAX package
``repro`` (``repro_torch`` is the port itself) or ``ml_dtypes`` (JAX's
numpy dtypes, which the card's machine does not have: the checkpoints
read bf16 through torch).  Checked on the syntax tree, so imports
inside functions count too."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro", "ml_dtypes")


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in BANNED


def _imports(path: pathlib.Path) -> list[tuple[int, str]]:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append((node.lineno, node.module or ""))
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            found.append((node.lineno, node.args[0].value))
    return found


def test_the_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/models/transformer.py" in names
    assert len(names) > 40


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [f"{path.name}:{line} imports {mod}"
           for line, mod in _imports(path) if _banned(mod)]
    assert not bad, bad


@pytest.mark.parametrize("source,banned", [
    ("import jax", True),
    ("import jax.numpy as jnp", True),
    ("from jaxlib import xla_client", True),
    ("from repro.core import compile", True),
    ("import repro", True),
    ("def f():\n    import repro.models.layers\n", True),
    ("importlib.import_module('repro.configs.base')", True),
    ("import ml_dtypes", True),
    ("from repro_torch.core import compile", False),
    ("import repro_torch.kernels.ops", False),
    ("from . import ops", False),
    ("import numpy, torch", False),
])
def test_the_scan_catches_what_it_should(tmp_path, source, banned):
    f = tmp_path / "m.py"
    f.write_text(source)
    assert any(_banned(m) for _, m in _imports(f)) == banned
