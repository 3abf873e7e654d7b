"""The plain reference against the port's plain path (its kernels' CPU
versions) at a tiny size in float32, for both architectures: the
last-position logits of a prefill, and one training step's loss, first
gradient and change, leaf by leaf."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import check, generator, spec, weights  # noqa: E402
from portbench.reference import model as reference  # noqa: E402
from portbench.testing import few_threads, tiny_conf  # noqa: E402,F401

CONFIGS = ["deepseek-v2-lite-16b", "qwen2-7b"]
TRAIN = json.loads((ROOT / "portbench/traffic/train_4k.json").read_text())


def _tiny(name: str):
    from repro_torch.configs import get_config
    import dataclasses

    conf = tiny_conf(json.loads(
        (ROOT / f"portbench/configs/{name}.json").read_text()))
    cfg = dataclasses.replace(get_config(conf["port_arch"]),
                              **spec.model_fields(conf), remat=False,
                              moe_impl="dense")
    return conf, cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_last_logits_match_the_port(name):
    from repro_torch.models.transformer import prefill

    conf, cfg = _tiny(name)
    torch.manual_seed(0)
    w = weights.make(conf, 2147483659, "cpu")
    tokens = torch.randint(0, conf["vocab_size"], (1, 48))
    got, _ = prefill(w, cfg, {"tokens": tokens}, cache_len=49)
    want = reference.last_logits(w, weights.sizes(conf), tokens[0])
    err = float((got[0] - want).abs().max() / want.abs().max())
    assert err < 1e-5
    assert check.logit_gap(want, int(got[0].argmax())) == 0.0


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_matches_the_port(name):
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    conf, cfg = _tiny(name)
    sz = weights.sizes(conf)
    tr = {**TRAIN, "batch": 2, "seq": 24}
    opt_cfg = AdamWConfig(**tr["optimizer"])
    w = weights.make(conf, 11, "cpu")
    w0 = weights.make(conf, 11, "cpu")
    batch = generator.train_batch(tr, conf["vocab_size"], 11, 0, "cpu")
    opt = adamw_init(w, opt_cfg)
    w, opt, metrics = make_train_step(cfg, TrainConfig(opt_cfg))(
        w, opt, batch)
    prog = {"losses": [float(metrics["loss"])],
            "grad_norms": {n: float(t.norm()) / (1 - opt_cfg.b1)
                           for n, t in weights.named_leaves(opt["m"])},
            "change_norms": {n: float((p - p0).norm()) for (n, p), (_, p0)
                             in zip(weights.named_leaves(w),
                                    weights.named_leaves(w0))}}
    ref = reference.train_steps(w0, sz, [(batch["tokens"], batch["labels"])],
                                tr["optimizer"], dtype=torch.float32)
    got, _ = check.train_readings(prog, ref)
    assert got["loss_gap"] < 1e-6
    assert got["grad_norm_gap"] < 1e-5
    # AdamW's m / sqrt(v) turns a rounding-sized gradient into a step of
    # up to lr, so a leaf's change agrees to ~1e-3 where its gradient does
    # to ~1e-7
    assert got["change_norm_gap"] < 2e-2
    assert set(prog["grad_norms"]) == set(ref["grad_norms"])


@pytest.mark.parametrize("fp8", ["rowwise", "tensorwise"])
def test_fp8_control_departs_from_float32(fp8):
    conf, _ = _tiny("qwen2-7b")
    sz = weights.sizes(conf)
    w = weights.make(conf, 5, "cpu")
    tokens = torch.randint(0, conf["vocab_size"], (40,))
    exact = reference.hidden(w, sz, tokens)
    low = reference.hidden(w, sz, tokens, fp8=fp8)
    rel = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < rel < 0.5


def test_fp8_gradients_pass_through_the_rounding():
    """The control's product has the gradient of its rounded operands,
    with the incoming gradient rounded to e5m2."""
    a = torch.randn(3, 5, 8, requires_grad=True)
    b = torch.randn(8, 4, requires_grad=True)
    reference.mm(a, b, "tensorwise").sum().backward()
    want_a = torch.ones(3, 5, 4) @ reference.q8(b.detach(), None).T
    assert torch.allclose(a.grad, want_a)
    assert b.grad.shape == b.shape
