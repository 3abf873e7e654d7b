"""The benchmark's inputs: the replay set of prompt lengths, the token
draws and the training batches repeat for a seed; the weights' layout is
the port's parameter tree."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import generator, spec, weights  # noqa: E402

LONGDOC = json.loads((ROOT / "portbench/traffic/prefill_longdoc.json")
                     .read_text())
TRAIN = json.loads((ROOT / "portbench/traffic/train_4k.json").read_text())
BIG = 2**31 + 11


def test_replay_lengths_are_the_log_uniform_quantiles():
    lengths = generator.prompt_lengths(LONGDOC["lengths"])
    want = [round(8192 * 4 ** ((i + 0.5) / 16)) for i in range(16)]
    assert lengths == want
    assert lengths[0] == 8555 and lengths[-1] == 31379


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_prompts_repeat_for_a_seed(seed):
    a, b = (generator.Prompts(LONGDOC, 102400, seed) for _ in range(2))
    assert a.order == b.order
    for j in (0, 5, 16, 33):
        assert np.array_equal(a.prompt(j), b.prompt(j))
        assert len(a.prompt(j)) == a.length(j)
        assert a.prompt(j).max() < 102400
    for x, y in zip(a.warm(), b.warm()):
        assert np.array_equal(x, y)


def test_every_seed_sends_the_same_lengths_in_another_order():
    a = generator.Prompts(LONGDOC, 1000, 1)
    b = generator.Prompts(LONGDOC, 1000, BIG)
    assert sorted(a.order) == sorted(b.order) == a.lengths
    assert a.order != b.order
    assert not np.array_equal(a.prompt(0)[:64], b.prompt(0)[:64])


@pytest.mark.parametrize("seed", [3, BIG])
def test_train_batches_repeat_and_differ(seed):
    tiny = {**TRAIN, "batch": 2, "seq": 16}
    x = generator.train_batch(tiny, 500, seed, 4, "cpu")
    y = generator.train_batch(tiny, 500, seed, 4, "cpu")
    z = generator.train_batch(tiny, 500, seed, 5, "cpu")
    assert torch.equal(x["tokens"], y["tokens"])
    assert torch.equal(x["labels"][:, :-1], x["tokens"][:, 1:])
    assert not torch.equal(x["tokens"], z["tokens"])
    assert x["tokens"].shape == (2, 16)


def test_subseed_streams_differ_and_repeat():
    assert spec.subseed(BIG, "weights") == spec.subseed(BIG, "weights")
    assert spec.subseed(BIG, "weights") != spec.subseed(BIG, "order")
    assert 0 <= spec.subseed(BIG, "batch", 3) < 2**63


CONFIGS = sorted(p.stem for p in (ROOT / "portbench/configs").glob("*.json"))


def _conf(config: str) -> dict:
    return json.loads((ROOT / f"portbench/configs/{config}.json").read_text())


@pytest.mark.parametrize("config", CONFIGS)
def test_layout_is_the_ports_parameter_tree(config):
    from repro_torch.models.transformer import param_shapes

    port = param_shapes(spec.model_config(_conf(config)))
    ours = weights.layout(_conf(config))
    assert {k: tuple(v) for k, v in ours["layers"].items()} == \
        {k: tuple(v) for k, v in port["layers"].items()}
    assert {k: tuple(v) for k, v in ours.items() if k != "layers"} == \
        {k: tuple(v) for k, v in port.items() if k != "layers"}


@pytest.mark.parametrize("config", CONFIGS)
def test_config_file_is_the_ports_config_but_for_its_cuts(config):
    """Every size the file gives is the port's registered one, except
    the keys ``reduced`` names (the pipeline stage's depth), and each
    cut key's published value is in ``published``."""
    import dataclasses

    from repro_torch.configs import get_config

    conf = _conf(config)
    port = dataclasses.asdict(get_config(conf["port_arch"]))
    cut = {spec._COMMON.get(k) for k in conf["reduced"]}
    for field, value in spec.model_fields(conf).items():
        if field not in cut:
            assert port[field] == value, field
    for key in conf["reduced"]:
        assert conf["published"][key] != conf[key], key


def test_pipeline_stage_is_the_whole_model_cut_in_depth():
    """The training cell's stage is Qwen2-7B's file but for its depth:
    7 of the 28 layers."""
    whole, stage = _conf("qwen2-7b"), _conf("qwen2-7b-pp4-stage")
    assert whole["reduced"] == [] and whole["num_hidden_layers"] == 28
    assert stage["reduced"] == ["num_hidden_layers"]
    assert stage["num_hidden_layers"] * 4 == whole["num_hidden_layers"]
    skip = {"num_hidden_layers", "reduced", "published", "assumed"}
    assert {k: v for k, v in stage.items() if k not in skip} == \
        {k: v for k, v in whole.items() if k not in skip}


def test_weights_repeat_for_a_seed():
    conf = json.loads((ROOT / "portbench/configs/qwen2-7b.json").read_text())
    from portbench.testing import tiny_conf

    small = tiny_conf(conf)
    a = weights.make(small, BIG, "cpu")
    b = weights.make(small, BIG, "cpu")
    c = weights.make(small, BIG + 1, "cpu")
    for (n, x), (_, y), (_, z) in zip(weights.named_leaves(a),
                                      weights.named_leaves(b),
                                      weights.named_leaves(c)):
        assert torch.equal(x, y), n
        assert not torch.equal(x, z), n
    assert float(a["layers"]["ln1_g"].mean()) == pytest.approx(1.0, abs=0.01)
