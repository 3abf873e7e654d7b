"""The control (the reference in the program's place with its matrix
products' operands in float8 e4m3) and the half-batch fault, at a tiny
size on the CPU: the readings ``control.py`` takes on the card at each
cell's own size, here against the program's own readings at the same
size, which they must exceed many times."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import check, control, spec, testing  # noqa: E402
from portbench.testing import few_threads  # noqa: E402,F401

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def root(tmp_path):
    return testing.tiny_root(tmp_path)


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if spec.cell(c).traffic["kind"] != "train"])
def test_serving_control_is_read_on_the_runs_own_sample(root, cell):
    """The control's reading is the run's own statistic on the run's own
    check sample, judged by the run's limits: the program's verdict is
    the run's, and the control's gap is read beside it."""
    c = spec.cell(cell, root)
    got = control.serving_run(c, 2147483659, "cpu", 0.3)
    assert got["checked"] >= 1
    program, ctl = got["program"]["readings"], got["control"]["readings"]
    assert set(program) == set(ctl) == {
        "served_logits_rms", "served_own_gap", "served_logit_gap"}
    assert got["program"]["correct"] is True
    assert ctl["served_logits_rms"] > max(10 * program["served_logits_rms"],
                                          1e-3)
    assert ctl["served_own_gap"] == program["served_own_gap"] == 0.0
    too_tight = {"served_logits_rms": ctl["served_logits_rms"] / 2}
    assert control._judged(got["control"]["readings"], too_tight) == \
        {"readings": got["control"]["readings"], "correct": False}


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if spec.cell(c).traffic["kind"] == "train"])
def test_training_control_and_half_batch_depart(root, capsys, cell):
    rc, line, _ = testing.run_cell(root, cell, capsys)
    program = {k: v["value"] for k, v in line["checks"].items()}
    got = control.training_control(spec.cell(cell, root), 2147483659, "cpu")
    for reading in ("control", "half_batch"):
        assert any(got[reading][k] > 10 * program[k] for k in program), \
            (reading, got[reading], program)
    assert got["half_batch_correct"] is False
    assert got["half_batch"]["grad_norm_gap"] > 0.05


def test_the_verdict_fails_a_reading_over_or_without_its_limit():
    limits = {"a": 1.0, "not_compared": {"b": "no upper reading"}}
    assert check.verdict({"a": 0.5, "b": 9.0}, limits) == \
        (True, {"a": {"value": 0.5, "limit": 1.0}})
    assert check.verdict({"a": 1.5}, limits)[0] is False
    assert check.verdict({"a": 0.5, "c": 0.0}, limits)[0] is False
    assert check.verdict({"a": float("nan")}, limits)[0] is False
