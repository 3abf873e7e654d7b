"""The benchmark's own counts: the model FLOPs of a prefill and of a
training step's forward against ``launch/_count.CostCounter`` (the
port's step on ``meta`` tensors) at a reduced size, the attention count
at MLA's D_qk ≠ D_v, the active parameters, and the busy union."""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import flops, spec, weights  # noqa: E402
from portbench.testing import few_threads, tiny_conf  # noqa: E402,F401


def _tiny(name: str):
    from repro_torch.configs import get_config

    conf = tiny_conf(json.loads(
        (ROOT / f"portbench/configs/{name}.json").read_text()), "bfloat16")
    cfg = dataclasses.replace(get_config(conf["port_arch"]),
                              **spec.model_fields(conf), remat=False,
                              moe_impl="dense")
    return conf, cfg


def _counted(cfg, fn) -> int:
    from repro_torch.launch._count import CostCounter
    from repro_torch.models.transformer import abstract

    params = abstract(cfg)
    counter = CostCounter()
    with counter, torch.no_grad():
        fn(params)
    return counter.flops


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "qwen2-7b"])
@pytest.mark.parametrize("s", [64, 200])
def test_prefill_flops_match_the_counter(name, s):
    """Equal for qwen2.  For MLA the counter takes the kernel's own
    report, 4·D a kept pair at D = D_qk = 192 (V padded to the key's
    width); the benchmark counts the model's 2·(D_qk + D_v), so the
    counter is higher by the padding's 2·(D_qk − D_v) a pair and head."""
    from repro_torch.models.transformer import prefill

    conf, cfg = _tiny(name)
    sz = weights.sizes(conf)
    tokens = torch.zeros((1, s), dtype=torch.long, device="meta")
    got = _counted(cfg, lambda p: prefill(p, cfg, {"tokens": tokens},
                                          cache_len=s + 1))
    want = flops.prefill_flops(sz, s)
    dqk, dv = flops.qk_v_dims(sz)
    padding = sz["L"] * sz["h"] * 2 * (dqk - dv) * flops.causal_pairs(s)
    assert got == want + padding


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "qwen2-7b"])
def test_train_forward_flops_match_the_counter(name):
    from repro_torch.models.transformer import forward_train

    conf, cfg = _tiny(name)
    sz = weights.sizes(conf)
    b, s = 2, 96
    batch = {"tokens": torch.zeros((b, s), dtype=torch.long, device="meta"),
             "labels": torch.zeros((b, s), dtype=torch.long, device="meta")}
    got = _counted(cfg, lambda p: forward_train(p, cfg, batch))
    want = flops.train_step_flops(sz, b, s) // 3
    dqk, dv = flops.qk_v_dims(sz)
    padding = sz["L"] * sz["h"] * 2 * (dqk - dv) * b * flops.causal_pairs(s)
    assert got == want + padding


def test_mla_attention_counts_its_two_head_sizes():
    conf = json.loads(
        (ROOT / "portbench/configs/deepseek-v2-lite-16b.json").read_text())
    sz = weights.sizes(conf)
    assert flops.qk_v_dims(sz) == (192, 128)
    s = 1000
    pairs = sum(i + 1 for i in range(s))
    assert flops.causal_pairs(s) == pairs
    assert flops.attention_flops(sz, pairs) == 27 * 16 * 2 * (192 + 128) \
        * pairs
    # the backward: scores again, dP, dV, dQ, dK
    ops = 16 * (6 * 192 + 4 * 128) * pairs
    assert flops.attention_bwd_least_s(sz, 1, s) == pytest.approx(
        max(ops / flops.BF16_FLOPS,
            2 * s * (2 * (16 * 192 * 2 + 16 * 128) + 2 * 16 * 128)
            / flops.HBM_BYTES_PER_S))


def test_active_params_count_shared_experts_once():
    conf = json.loads(
        (ROOT / "portbench/configs/deepseek-v2-lite-16b.json").read_text())
    sz = weights.sizes(conf)
    per_token = flops.active_params(sz) - 2 * sz["d"] * sz["V"]
    assert per_token == pytest.approx(2.24e9, rel=0.01)
    assert 2 * sz["L"] * flops.layer_matrix_params(sz) == pytest.approx(
        4.49e9, rel=0.01)
    for name, layer_flops in (("qwen2-7b-pp4-stage", 3.26e9),
                              ("qwen2-7b", 13.05e9)):
        qwen = weights.sizes(json.loads(
            (ROOT / f"portbench/configs/{name}.json").read_text()))
        assert 2 * qwen["L"] * flops.layer_matrix_params(qwen) == \
            pytest.approx(layer_flops, rel=0.01)


def test_busy_is_the_union_of_intervals():
    assert flops.busy([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert flops.busy([]) == 0.0
