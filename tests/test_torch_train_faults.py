"""Two faults of the port's train step, on the CPU at reduced
tinyllama-1.1b.

* A step leaves no parameter requiring grad: its gradients come through
  detached views of the leaves, so the trained tensors serve at once.
  On the card, serving calls kernels that have no backward
  (``flash_decode``, ``int8_matmul``), whose wrappers refuse inputs that
  require grad; fake CUDA tensors here show that a trained tree reaches
  their libraries' ``load`` instead.
* Gradient accumulation cuts the batch as the reference reshapes it, to
  ``(accum_steps, B // accum_steps, ...)``: a first axis that does not
  divide by ``accum_steps`` raises ``TypeError`` in both packages, before
  any gradient is taken; one that does matches the reference's step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.models.transformer import Runtime
from repro.models.transformer import init_params as ref_init_params
from repro.train import optimizer as ref_opt
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.models.transformer import decode_step, init_params, prefill
from repro_torch.train import optimizer as opt
from repro_torch.train._tree import leaves, tree_map
from repro_torch.train.trainer import (
    TrainConfig,
    make_train_step,
    train_loop,
    value_and_grad,
)

ARCH = "tinyllama-1.1b"


def _cfg():
    return get_config(ARCH).reduced()


def _params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _batch(cfg, b: int, s: int = 16, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
            .astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s))
            .astype(np.int32)}


def _tcfg(accum_steps: int = 1) -> TrainConfig:
    return TrainConfig(optimizer=opt.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=4), accum_steps=accum_steps)


def _no_leaf_requires_grad(params) -> bool:
    return not any(p.requires_grad for p in leaves(params))


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_leaves_no_parameter_requiring_grad(accum_steps):
    cfg = _cfg()
    params = _params(cfg)
    step = make_train_step(cfg, _tcfg(accum_steps))
    params, _, metrics = step(params, opt.adamw_init(params, _tcfg().optimizer),
                              _batch(cfg, 4))
    assert np.isfinite(float(metrics["loss"]))
    assert _no_leaf_requires_grad(params)


def test_train_loop_leaves_no_parameter_requiring_grad():
    cfg = _cfg()
    params = _params(cfg)
    seen = []
    out = train_loop(cfg, _tcfg(), params,
                     opt.adamw_init(params, _tcfg().optimizer),
                     [_batch(cfg, 2, seed=i) for i in range(2)],
                     hooks=[lambda step, p, s, m: seen.append(
                         _no_leaf_requires_grad(p))])
    assert seen == [True, True]
    assert len(out["history"]) == 2
    assert _no_leaf_requires_grad(out["params"])


def test_launcher_and_elastic_run_leave_no_parameter_requiring_grad(
        tmp_path, capsys):
    from repro_torch.data import DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train.elastic import ElasticRun, run_elastic

    out = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                             "--batch", "2", "--seq", "16", "--device",
                             "cpu"])
    assert _no_leaf_requires_grad(out["params"])
    cfg = _cfg()
    run = ElasticRun(cfg=cfg, tcfg=_tcfg(),
                     data=DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                     global_batch=2),
                     ckpt_dir=tmp_path / "ckpt", ckpt_every=1)
    out = run_elastic(run, total_steps=2, device="cpu")
    assert _no_leaf_requires_grad(out["params"])


def test_value_and_grad_is_the_gradient_of_the_leaves():
    """The views' gradients are the leaves' own: the same as
    ``torch.autograd.grad`` over leaves that require grad."""
    from repro_torch.models.transformer import forward_train

    cfg = _cfg()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2).items()}
    params = _params(cfg)
    loss, grads = value_and_grad(params, cfg, batch)
    assert _no_leaf_requires_grad(params)
    own = tree_map(lambda t: t.clone().requires_grad_(True), params)
    want_loss = forward_train(own, cfg, batch)
    want = torch.autograd.grad(want_loss, leaves(own))
    assert torch.equal(loss, want_loss.detach())
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


def test_trained_parameters_serve_without_grad():
    cfg = _cfg()
    params = _params(cfg)
    params, _, _ = make_train_step(cfg, _tcfg())(
        params, opt.adamw_init(params, _tcfg().optimizer), _batch(cfg, 2))
    tokens = torch.from_numpy(_batch(cfg, 2)["tokens"][:, :8])
    logits, state = prefill(params, cfg, {"tokens": tokens}, cache_len=16)
    assert not logits.requires_grad
    logits, _ = decode_step(params, cfg, state, tokens[:, -1])
    assert not logits.requires_grad and bool(torch.isfinite(logits).all())


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_trained_parameters_reach_the_serving_kernels_on_cuda(monkeypatch):
    """The trained tree's flags on CUDA tensors (fake ones: this host has
    no card): a decode query projected by a trained ``wq`` reaches the
    decode library, and an int8 column scale taken from it the int8
    library, neither refused for a gradient."""
    from repro_torch.kernels import int8_matmul as im

    class Loaded(Exception):
        pass

    def refuse():
        raise Loaded

    for lib in (fd.LIBRARY, im.LIBRARY):
        monkeypatch.setattr(lib, "load", refuse)
    cfg = _cfg()
    params = _params(cfg)
    params, _, _ = make_train_step(cfg, _tcfg())(
        params, opt.adamw_init(params, _tcfg().optimizer), _batch(cfg, 2))
    b, s = 2, 16
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # (a CUDA tensor that requires grad aborts this CPU build of PyTorch)
    assert _no_leaf_requires_grad(params)
    with FakeTensorMode():
        card = tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="cuda").requires_grad_(
                t.requires_grad), params)
        # the layers' stacked wq [L, d, H·D] as one [L·d, H·D] projection
        wq = card["layers"]["wq"].flatten(0, 1)
        x = torch.empty((b, wq.shape[0]), device="cuda")
        cache = torch.empty((b, s, kh, d), device="cuda")
        lens = torch.empty(b, dtype=torch.int32, device="cuda")
        with pytest.raises(Loaded):
            fd.flash_decode((x @ wq).view(b, h, d), cache, cache, lens)
        w8 = torch.empty(wq.shape, dtype=torch.int8, device="cuda")
        x8 = torch.empty((32, wq.shape[0]), dtype=torch.int8, device="cuda")
        with pytest.raises(Loaded):
            im.int8_matmul(x8, w8, torch.empty(32, device="cuda"),
                           wq.abs().amax(0) / 127)


@functools.lru_cache(maxsize=None)
def _reference():
    rcfg = ref_get_config(ARCH).reduced()
    params, _ = ref_init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, jax.tree.map(np.asarray, params)


def _ref_step(accum_steps: int):
    rcfg, tree = _reference()
    rc = ref_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    params = jax.tree.map(jnp.asarray, tree)
    state, _ = ref_opt.adamw_init(params, None, rc)
    step = jax.jit(ref_make_train_step(
        rcfg, RefTrainConfig(optimizer=rc, accum_steps=accum_steps),
        Runtime()))
    return lambda batch: step(params, state, {
        k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("b,accum_steps", [(5, 2), (6, 4)])
def test_uneven_microbatches_raise_type_error_as_in_the_reference(
        b, accum_steps, monkeypatch):
    cfg = _cfg()
    batch = _batch(cfg, b)
    with pytest.raises(TypeError):
        _ref_step(accum_steps)(batch)
    _, tree = _reference()
    params = lm_params_from_numpy(tree, cfg, "cpu")
    before = [t.clone() for t in leaves(params)]
    taken = []
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        lambda *a, **kw: taken.append(1))
    step = make_train_step(cfg, _tcfg(accum_steps))
    with pytest.raises(TypeError, match="microbatches"):
        step(params, opt.adamw_init(params, _tcfg().optimizer), batch)
    assert not taken
    assert all(torch.equal(x, y) for x, y in zip(leaves(params), before))


def test_even_microbatches_match_the_reference():
    """B = 6 in two microbatches of 3: loss and gradient norm as the
    reference's step (tolerances of test_torch_train.py)."""
    cfg = _cfg()
    batch = _batch(cfg, 6, seed=3)
    _, _, want = _ref_step(2)(batch)
    _, tree = _reference()
    params = lm_params_from_numpy(tree, cfg, "cpu")
    _, _, got = make_train_step(cfg, _tcfg(2))(
        params, opt.adamw_init(params, _tcfg().optimizer), batch)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                               rel=1e-5)
    assert float(got["grad_norm"]) == pytest.approx(
        float(want["grad_norm"]), rel=1e-5)
