"""Whole runs of every cell at a tiny size on the CPU (``run.main`` with
the look for a card skipped): the result line's keys, the checks printed
last, a run refused without a card, planted faults that ``correct``
must catch, and a cell, configuration, traffic mix and metric added as
files and entries alone."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.testing import few_threads  # noqa: E402,F401
from portbench import spec, testing  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
PREFILL = [c for c in CELLS if spec.cell(c).traffic["kind"] != "train"]
TRAIN = [c for c in CELLS if spec.cell(c).traffic["kind"] == "train"]


@pytest.fixture
def root(tmp_path):
    return testing.tiny_root(tmp_path)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(root, capsys, cell, trace):
    rc, line, err = testing.run_cell(root, cell, capsys, trace=trace)
    assert rc == 0
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    c = spec.cell(cell)
    want = {m["name"]: m["unit"] for m in (c.per_layer if trace
                                           else c.end_to_end)}
    got = {k: v["unit"] for k, v in line["metrics"].items()}
    if trace:
        # the CPU has no device trace: only the host-clock readers read
        assert set(got) <= set(want)
        assert any(k.startswith("mfu") for k in got)
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want
        assert all(v["value"] > 0 for v in line["metrics"].values())
    checks = [ln for ln in err if ln.startswith("check ")]
    assert err[-len(checks):] == checks and checks
    for name, c in line["checks"].items():
        assert c["limit"] is not None and c["value"] <= c["limit"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA device, and in a directory that holds only
    ``BENCHMARK.json`` and the benchmark's files, a run exits non-zero
    and prints nothing on standard output."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("cell", PREFILL)
def test_a_served_token_altered_is_not_correct(root, capsys, monkeypatch,
                                               cell):
    import numpy as np

    from repro_torch.serve.engine import ServingEngine

    step = ServingEngine.step

    def altered(self):
        """Emit the least likely token of the slot's logits instead."""
        return [(rid, int(np.argmin(self._logits[0])))
                for rid, _ in step(self)]

    monkeypatch.setattr(ServingEngine, "step", altered)
    rc, line, _ = testing.run_cell(root, cell, capsys)
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        root, capsys, monkeypatch, cell):
    import torch

    from repro_torch.train import trainer

    def unchanged(grads, state, params, cfg, *args):
        zero = torch.zeros(())
        return params, state, {"lr": zero, "grad_norm": zero}

    monkeypatch.setattr(trainer, "adamw_update", unchanged)
    rc, line, _ = testing.run_cell(root, cell, capsys)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_a_number_not_compared_is_shown_before_the_checks(root, capsys,
                                                          cell):
    """A reading that the cell's limits name under ``not_compared`` is
    printed with its reason, is not in ``checks`` and decides nothing."""
    skip = spec.cell(cell).limits["not_compared"]
    rc, line, err = testing.run_cell(root, cell, capsys)
    assert rc == 0 and line["correct"] is True
    assert not set(skip) & set(line["checks"])
    for name in skip:
        shown = [ln for ln in err if f" {name} " in ln]
        assert shown and "not compared" in shown[0]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_is_not_correct(root, capsys, monkeypatch,
                                                cell):
    from repro_torch.train import trainer

    loss_fn = trainer.loss_fn

    def half(params, cfg, batch, rt=None):
        rows = batch["tokens"].shape[0] // 2
        return loss_fn(params, cfg, {k: v[:rows] for k, v in batch.items()},
                       rt)

    monkeypatch.setattr(trainer, "loss_fn", half)
    rc, line, _ = testing.run_cell(root, cell, capsys)
    assert rc == 0 and line["correct"] is False


def test_a_cell_added_as_files_and_entries(root, capsys):
    """A new configuration, traffic mix, cell and per-layer metric are
    found by their names; no file of the benchmark is edited."""
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    here = root / "portbench"
    conf = json.loads((here / "configs/qwen2-7b.json").read_text())
    conf.update(hidden_size=96, num_attention_heads=6, num_key_value_heads=3)
    (here / "configs/qwen2-mini.json").write_text(json.dumps(conf))
    tr = json.loads((here / "traffic/prefill_longdoc.json").read_text())
    tr["lengths"] = {"min": 8, "max": 24, "quantiles": 3, "spacing": "linear"}
    (here / "traffic/prefill_short.json").write_text(json.dumps(tr))
    (here / "metrics/requests.prefill.py").write_text(
        "def read(window, trace):\n    return float(window['requests'])\n")
    (here / "limits/qwen2-mini.prefill_short.json").write_text(
        (here / "limits/qwen2-7b.prefill_longdoc.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = "qwen2-mini.prefill_short"
    bench["configs"].append({"name": "qwen2-mini", "source": "test",
                             "file": "portbench/configs/qwen2-mini.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": "qwen2-mini",
                               "traffic": "prefill_short", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("prefill_tokens_per_s", "ttft_p90_ms"):
            m["workloads"].append(name)
    bench["per_layer"].append({"name": "requests.prefill", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "ttft_p90_ms",
                               "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line, _ = testing.run_cell(root, name, capsys, trace=1)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["requests.prefill"]["value"] == line["attempted"]
    rc, line, _ = testing.run_cell(root, name, capsys, trace=0)
    assert set(line["metrics"]) == {"setup_s", "prefill_tokens_per_s",
                                    "ttft_p90_ms"}
    for p, data in before.items():
        assert p.read_bytes() == data, p
