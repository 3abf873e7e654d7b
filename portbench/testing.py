"""A copy of the benchmark at a tiny size, for the CPU tests: the same
files, with every configuration cut to a few dimensions and every
traffic mix to a few short requests or rows, run in-process on the CPU
(``run.main(device="cpu")``)."""

from __future__ import annotations

import importlib.util
import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

TINY_CONFIGS = {
    "deepseek_v2": dict(hidden_size=64, num_attention_heads=4,
                        num_key_value_heads=4, qk_nope_head_dim=16,
                        qk_rope_head_dim=16, v_head_dim=16, kv_lora_rank=32,
                        n_routed_experts=8, num_experts_per_tok=2,
                        n_shared_experts=1, moe_intermediate_size=32,
                        num_hidden_layers=2, vocab_size=256),
    "qwen2": dict(hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=128,
                  num_hidden_layers=2, vocab_size=256),
}
TINY_TRAFFIC = {
    "prefill_closed": dict(cache_len=65, trace_requests=4, check_tokens=128,
                           lengths={"min": 16, "max": 64, "quantiles": 4,
                                    "spacing": "log"}),
    "train": dict(batch=2, seq=32),
}


def tiny_conf(conf: dict, dtype: str = "float32") -> dict:
    return {**conf, **TINY_CONFIGS[conf["model_type"]], "torch_dtype": dtype}


def tiny_root(dest: Path, dtype: str = "float32") -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``portbench/`` with every
    configuration and traffic file cut to a tiny size."""
    shutil.copytree(HERE, dest / HERE.name,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (dest / HERE.name / "configs").glob("*.json"):
        conf = json.loads(path.read_text())
        path.write_text(json.dumps(tiny_conf(conf, dtype)))
    for path in (dest / HERE.name / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update(TINY_TRAFFIC[tr["kind"]])
        path.write_text(json.dumps(tr))
    return dest


def runner():
    """``portbench/run.py`` as a module."""
    spec = importlib.util.spec_from_file_location("portbench_run",
                                                  HERE / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(root: Path, workload: str, capsys, seed: int = 2147483659,
             seconds: float = 0.3, trace: int = 0) -> tuple[int, dict, list]:
    """Run one cell on the CPU: (exit code, the result line, the stderr
    lines)."""
    import torch

    torch.manual_seed(0)
    rc = runner().main(["--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       device="cpu", root=root)
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    line = json.loads(lines[-1]) if rc == 0 and lines else {}
    return rc, line, captured.err.strip().splitlines()


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads while a test runs (the suite runs in several
    processes at once), restored after it."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
