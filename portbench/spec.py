"""What a cell is, read from ``BENCHMARK.json`` and the files it names.

A workload names a configuration and a traffic mix; each is a data file
found by its name (``configs/<config>.json``, ``traffic/<traffic>.json``),
and a cell's limits for the correctness check are ``limits/<cell>.json``.
The end-to-end and per-layer metrics are the entries of ``BENCHMARK.json``
that list the cell (or list no cells); a per-layer metric's reader is
``metrics/<metric>.py``.  Nothing here names a cell, so a later cell,
configuration, traffic mix or metric is a new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# config.json keys → the port's ModelConfig fields, for every model type
_COMMON = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
           "num_attention_heads": "n_heads",
           "num_key_value_heads": "n_kv_heads", "vocab_size": "vocab_size",
           "rope_theta": "rope_theta",
           "tie_word_embeddings": "tie_embeddings",
           "torch_dtype": "dtype"}
_MOE = {"n_routed_experts": "n_experts", "num_experts_per_tok": "moe_top_k",
        "n_shared_experts": "n_shared_experts",
        "moe_intermediate_size": "d_ff_expert", "kv_lora_rank": "kv_lora_rank",
        "qk_nope_head_dim": "head_dim", "qk_rope_head_dim": "rope_head_dim"}


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of the run (weights, prompts, batch
    i, the check's sample), the same for the same ``seed`` and tags."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    digest = hashlib.blake2b(text, digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def model_fields(conf: dict) -> dict:
    """The port's ModelConfig fields that a configuration file sets, by
    its config.json keys (qwen2's head dim is hidden / heads; its q, k, v
    have biases; a deepseek_v2 file gives MLA's and the experts' sizes)."""
    out = {field: conf[key] for key, field in _COMMON.items() if key in conf}
    out["tie_embeddings"] = bool(out.get("tie_embeddings", False))
    out["rope_theta"] = float(out["rope_theta"])
    if conf["model_type"] == "deepseek_v2":
        out.update({field: conf[key] for key, field in _MOE.items()})
        out["family"] = "moe"
    elif conf["model_type"] == "qwen2":
        out["d_ff"] = conf["intermediate_size"]
        out["head_dim"] = conf["hidden_size"] // conf["num_attention_heads"]
        out["qkv_bias"] = True
        out["family"] = "dense"
    else:
        raise ValueError(f"no translation for model_type "
                         f"{conf['model_type']!r}")
    return out


@dataclasses.dataclass
class Cell:
    name: str
    conf: dict            # the configuration file
    traffic: dict         # the traffic file
    limits: dict          # limits/<cell>.json
    chips: int
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def model_config(conf: dict, traffic: dict | None = None):
    """The port's ModelConfig of a configuration file: the port's
    registered architecture with the file's sizes (and a traffic mix's
    remat)."""
    from repro_torch.configs import get_config

    fields = model_fields(conf)
    if traffic and "remat" in traffic:
        fields["remat"] = bool(traffic["remat"])
    return dataclasses.replace(get_config(conf["port_arch"]), **fields)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench if bench is not None else benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    here = root / HERE.name
    limits_path = here / "limits" / f"{name}.json"
    return Cell(
        name=name, conf=load_json(root / conf_entry["file"]),
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(limits_path) if limits_path.exists() else {},
        chips=w["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """``metrics/<metric>.py``'s ``read``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    return load_module(path, "portbench_metric_" + metric.replace(".", "_"))


def kind(traffic: dict, root: Path = ROOT):
    """The module that runs a traffic mix's ``kind``: ``kinds/<kind>.py``."""
    path = root / HERE.name / "kinds" / f"{traffic['kind']}.py"
    return load_module(path, "portbench_kind_" + traffic["kind"])


@dataclasses.dataclass
class Run:
    """One run of a cell: what the command line gave, and when the
    process started (the start of ``setup_s``).  ``control`` (set by
    ``control.py`` alone) also reads the control on the run's own check
    sample: the fp8 recipe of ``reference.model.mm``."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float
    control: str | None = None

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize(self.device)
